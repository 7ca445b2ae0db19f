"""Adaptive throughput benchmark harness on the card.

The policy of the JAX package's ``minnow_c_tpu/bench/harness.py`` (the
reference's ``src/bench.{h,c}``): trials double in size until a single
trial takes at least ``target_trial_s`` or four more would pass the budget
``max_total_s``; the median of up to three trials at the final size
within the budget is reported, as bytes per second of processed data.

The doubling is over iterations of one call, ``fn(salt)``.  Every call
gets a fresh salt, computed on the device from the previous call's first
output element and a strictly increasing count of calls
(``derive_salt``): each call depends on the one before, no two salts of a
run repeat, and no iteration reads anything back to the host.  (The JAX
package XORs the output's bits with the count, which repeats once the
output follows the salt: a u32 prefix sum whose element 0 is salted
closes a cycle within tens of calls.  The count stays in the low bits, as
there, so that a body that takes only the salt's low bits alternates its
input.)  The last four
outputs stay alive.  A trial ends with the host read of its final salt,
which depends on every call of the trial; on the card it is timed by CUDA
events on the current stream around the calls and that read, on the CPU
by ``time.perf_counter``.  The budget's clock is ``time.perf_counter``.
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass
from typing import Callable

import torch

TARGET_TRIAL_S = 0.5  # bench.h:6
MAX_TOTAL_S = 30.0  # bench.h:7
BURN_IN_S = 3.0     # calls before the first trial, each waited for
WINDOW = 4          # outputs held alive
FLOOR = 0.9         # least time an iteration over its calls' device time
_M32 = 0xFFFFFFFF
_SIGN = 1 << 31


@dataclass
class Result:
    bytes_per_second: float
    iterations: int
    trial_seconds: float

    @property
    def gb_per_second(self) -> float:
        return self.bytes_per_second / 1e9


def _first_leaf(out) -> torch.Tensor:
    while not isinstance(out, torch.Tensor):
        out = next(iter(out.values())) if isinstance(out, dict) else out[0]
    return out


def derive_salt(out, count: int) -> torch.Tensor:
    """The next salt, a 0-dim int32 tensor of u32 bits on the output's
    device: ``count`` mod 2^24 in bits 0-23 (distinct for the first 2^24
    calls of a run; a body that reads only the salt's low bits still gets
    a new input every call), and in bits 24-31 the low byte of the first
    element of the output's first tensor (float32 by its bits, int32 as it
    is, int64 by its low 32 bits)."""
    leaf = _first_leaf(out)
    v = leaf[(0,) * leaf.dim()]
    if v.dtype == torch.float32:
        v = v.view(torch.int32)
    elif v.dtype == torch.int64:
        v = (((v & _M32) ^ _SIGN) - _SIGN).to(torch.int32)
    elif v.dtype != torch.int32:
        raise TypeError(f"no salt from a {v.dtype} output")
    return ((v & 0xFF) << 24) | (count & 0xFFFFFF)


def describe_device(device="cuda") -> dict:
    """The device a record was measured on: for a card, its name, the
    ``nvidia-smi --query-gpu=name,power.limit`` line (a card may be set
    below its 700 W maximum, and runs slower under load then), and the
    torch and CUDA versions."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"type": device.type, "torch": torch.__version__}
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return {"type": "cuda", "name": torch.cuda.get_device_name(device),
            "nvidia_smi": r.stdout.strip().splitlines()[0],
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(fn: Callable[[torch.Tensor], object], bytes_per_iter: int,
        target_trial_s: float = TARGET_TRIAL_S,
        max_total_s: float = MAX_TOTAL_S, device="cuda",
        salts: list = None) -> Result:
    """Benchmark ``fn(salt)`` on ``device`` (``cuda`` unless the caller
    asks for ``cpu``).

    ``fn`` takes a 0-dim int32 tensor of u32 bits on ``device`` that MUST
    feed into its computation (XOR it into a key or an input element) and
    returns a tensor, or a tuple / list / dict whose first tensor the next
    salt is derived from.  ``bytes_per_iter`` is one call's bytes.  A list
    passed as ``salts`` receives the salts of the last trial (device
    tensors: read them after the run)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "to run on the CPU")
    count = 0

    def derive(out):
        nonlocal count
        count += 1
        return derive_salt(out, count)

    # Warm-up and burn-in, excluded (bench.c's pause / resume intent): the
    # kernels' build and first launches, the allocator's first blocks.
    salt = torch.zeros((), dtype=torch.int32, device=device)
    out = fn(salt)
    _wait(device)
    t_burn = time.perf_counter()
    while time.perf_counter() - t_burn < BURN_IN_S:
        out = fn(salt)
        salt = derive(out)
        _wait(device)
    del out
    last = []

    def trial(iters):
        nonlocal salt, last
        window, trial_salts = [], []
        if cuda:
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(salt)
            salt = derive(out)
            trial_salts.append(salt)
            window.append(out)
            if len(window) > WINDOW:
                window.pop(0)
        # Completion barrier: the host read of a value that depends on
        # every call of the trial.
        salt.item()
        dt = time.perf_counter() - t0
        if cuda:
            end.record(stream)
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        last = trial_salts
        return dt

    start_total = time.perf_counter()
    iters = 1
    while True:
        dt = trial(iters)
        elapsed = time.perf_counter() - start_total
        if dt >= target_trial_s or elapsed + dt * 4 > max_total_s:
            break
        iters *= 2
    # Median of three trials at the final size, within the wall budget
    # (bench.c enforces WALL_CLOCK_LIMIT as a hard stop).
    samples = [dt]
    while len(samples) < 3 and \
            time.perf_counter() - start_total + dt <= max_total_s:
        samples.append(trial(iters))
    dt = sorted(samples)[len(samples) // 2]
    if salts is not None:
        salts[:] = last
    return Result(bytes_per_second=bytes_per_iter * iters / dt,
                  iterations=iters, trial_seconds=dt)


def device_ms(fn: Callable[[torch.Tensor], object], device="cuda",
              calls: int = 5):
    """The card's time a call of ``fn(salt)`` at salt 0: all its activity
    (kernels, copies, memsets) in a torch.profiler trace of ``calls``
    calls, over ``calls``; None off the card, or where none of three
    traces holds device time."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    salt = torch.zeros((), dtype=torch.int32, device=device)
    fn(salt)
    torch.cuda.synchronize(device)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(salt)
            torch.cuda.synchronize(device)
        total = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / calls / 1e3
    return None


def check_floors(timed: dict, device="cuda") -> dict:
    """``timed``: name -> (fn, the harness's ms an iteration).  Traces each
    ``fn`` (``device_ms``; after the timing, since a trace's hooks stay
    in place) and returns name -> its device ms a call.  Raises
    AssertionError where an iteration took less than FLOOR x its call's
    device time (a call elided, or a trial ended before the card did) or
    where a trace held no device time.  Off the card: {}."""
    if torch.device(device).type != "cuda":
        return {}
    out, bad = {}, []
    for name, (fn, per_iter) in timed.items():
        out[name] = dev = device_ms(fn, device)
        if dev is None or per_iter < FLOOR * dev:
            bad.append(f"{name}: {per_iter:.4f} ms an iteration against "
                       f"{dev} ms of device time a call")
    if bad:
        raise AssertionError("harness below its device-time floor: "
                             + "; ".join(bad))
    return out
