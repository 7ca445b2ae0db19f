"""Profiling and tracing helpers (port of ``minnow_c_tpu/utils/profiling.py``).

* ``trace(dir)``     -- context manager around ``torch.profiler.profile``
  (host activity, and the card's kernels when CUDA is present); writes a
  Chrome trace (``trace.json``, opens in Perfetto) into ``dir``.
* ``annotate(name)`` -- named span (``torch.profiler.record_function``)
  that shows up inside profiler traces.
* ``timed(name)``    -- lightweight wall-clock span logger.
* ``phase(name)``    -- the production span: always an ``annotate``;
  additionally a ``timed`` print when ``MINNOW_PROFILE`` is set.  The
  snapshot writer and reader wrap their pipeline phases (stats, bin+pack,
  device-to-host gather, entropy, serialize, decode) in these, so
  ``MINNOW_PROFILE=1 python ...`` attributes wall time per phase and a
  ``trace()`` capture shows the same names on the timeline.  Kernels run
  asynchronously, so under ``MINNOW_PROFILE`` a phase synchronises the
  card at its start and end: the print then holds the device work the
  phase launched.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str = "minnow_trace"):
    """Profile the enclosed block; yields the ``torch.profiler.profile``
    object (for ``key_averages()``) and writes ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named span that shows up inside profiler traces."""
    return torch.profiler.record_function(name)


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase(name: str, sink=print, nbytes: int = 0):
    """Production pipeline span: a profiler ``annotate`` always, plus a
    wall-clock ``timed`` print when the ``MINNOW_PROFILE`` env var is
    set.  ``nbytes`` (optional) adds a GB/s figure to the print."""
    with contextlib.ExitStack() as st:
        st.enter_context(annotate(name))
        if os.environ.get("MINNOW_PROFILE"):
            _sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                _sync()
                dt = time.perf_counter() - t0
                rate = f"  ({nbytes / dt / 1e9:.2f} GB/s)" \
                    if nbytes and dt > 0 else ""
                sink(f"[minnow] {name}: {dt * 1e3:.2f} ms{rate}")
        else:
            yield


@contextlib.contextmanager
def timed(name: str, sink=print):
    """Wall-clock span: ``with timed("lz4"): ...`` prints the elapsed
    time.  Blocks on nothing -- callers must synchronise around device
    work they want attributed."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink(f"[minnow] {name}: {(time.perf_counter() - t0) * 1e3:.2f} ms")
