"""K10 and K11, the chunked-width delta decode (``csrc/chunked.cu``), their
plain torch versions, and the column-major body helpers.

Port of ``minnow_c_tpu/ops/chunked_pallas.py``.  A chunked plane (Coil v1.1,
Octo v1.1 at 16384-element chunks) stores per-chunk bit widths and each
chunk's packed words column-major (``body_to_cmajor``).

* K10 ``decode_chunked_stream`` / ``decode_chunked_stream_plain``: unpack
  each chunk at its width -> optional un-zigzag -> optional global inclusive
  u32 prefix sum + ``first`` -> u32 bins (int32 bits), as the JAX package's
  ``decode_chunked_stream``.
* K11 ``decode_chunked_stream_floats`` / ``..._plain``: K10, then in the
  same pass the Threefry dither, ``x0 + dx_bin*(bin + u)`` (one rounding for
  the multiply-add, as ``kernels.undo_bins``) and the optional periodic
  rewrap -> f32, as ``decode_chunked_stream_floats``.

The wrappers check the wire-sourced width table before anything runs: a
width above 32, a body shorter than the table needs, or ``n`` beyond the
table's chunks raise ValueError.  Each launches its CUDA kernel for a CUDA
tensor and runs the plain version only for a CPU tensor; there is no
fallback from one to the other.

A launch is one pass over the body: one block a half-chunk tile
(``TILE``), taken by ticket, the prefix carried across tiles by decoupled
look-back (``csrc/scan.cuh``, K9's code) in the status words that
``scan_cuda.status_words`` keeps per device and stream; the C entry point
clears them with one ``cudaMemsetAsync`` before the launch.  The host
makes one copy a call: the chunk table, which the C entry point builds in
a pinned slot of the device and stream's ``_Staging``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib, kernels
from .fastpath import undo_uniform
from .scan_cuda import cumsum_u32_plain, status_words

KERNEL_CHUNK = 16384  # the kernels' (only) chunk size
TILE = KERNEL_CHUNK // 2  # the kernels' tile: half a chunk, one status word


# ---------------------------------------------------------------------------
# The column-major chunk body (host, numpy)
# ---------------------------------------------------------------------------

def body_to_cmajor(natural: np.ndarray, width: int, chunk: int
                   ) -> np.ndarray:
    """Rearrange one chunk's packed words from natural bitstream order
    (word k = bits [32k, 32k+32)) to the v1.1 column-major wire layout
    (flat[c*M + m] = natural[4*width*m + c], M = chunk // 128)."""
    if width == 0:
        return natural
    M = chunk // 128
    return np.ascontiguousarray(
        np.asarray(natural).reshape(M, 4 * width).T).reshape(-1)


def body_from_cmajor(cmajor: np.ndarray, width: int, chunk: int
                     ) -> np.ndarray:
    """Inverse of :func:`body_to_cmajor`."""
    if width == 0:
        return cmajor
    M = chunk // 128
    return np.ascontiguousarray(
        np.asarray(cmajor).reshape(4 * width, M).T).reshape(-1)


def _chunk_slices(widths: np.ndarray, chunk: int):
    wpcs = (chunk * widths.astype(np.int64)) // 32
    offs = np.concatenate([[0], np.cumsum(wpcs)[:-1]]).astype(np.int64)
    for c, w in enumerate(widths):
        if w:
            yield int(w), slice(int(offs[c]), int(offs[c] + wpcs[c]))


def plane_to_cmajor(natural: np.ndarray, widths: np.ndarray,
                    chunk: int) -> np.ndarray:
    """A whole plane's natural-order chunk bodies (u32 words, as the chunk
    pack writes them) -> the v1.1 column-major layout, chunk by chunk
    (``algo_coil_v1_1._cmajor_blob`` of the JAX package)."""
    out = np.empty_like(natural)
    for w, s in _chunk_slices(widths, chunk):
        out[s] = body_to_cmajor(natural[s], w, chunk)
    return out


def plane_from_cmajor(cmajor: np.ndarray, widths: np.ndarray,
                      chunk: int) -> np.ndarray:
    """Inverse of :func:`plane_to_cmajor` (``_natural_blob``)."""
    wpcs = (chunk * widths.astype(np.int64)) // 32
    out = np.empty(int(wpcs.sum()), dtype=np.uint32)
    for w, s in _chunk_slices(widths, chunk):
        out[s] = body_from_cmajor(cmajor[s], w, chunk)
    return out


# ---------------------------------------------------------------------------
# K10 / K11
# ---------------------------------------------------------------------------

def _layout(body: torch.Tensor, widths, chunk: int, n: int) -> np.ndarray:
    """Validate a chunked stream before any decode; returns the width table
    (int64)."""
    widths = np.asarray(widths).reshape(-1).astype(np.int64, copy=False)
    if chunk <= 0 or chunk % 128:
        raise ValueError(f"chunk {chunk} is not a positive multiple of 128")
    if widths.size and (widths.max() > 32 or widths.min() < 0):
        raise ValueError(f"chunk width {int(widths.max())} > 32 in stream "
                         "width table")
    if body.dtype != torch.int32 or body.dim() != 1:
        raise TypeError("body must be a 1-D int32 tensor of u32 bits")
    need = int(widths.sum()) * (chunk // 32)
    if body.numel() < need:
        raise ValueError(f"chunk body of {body.numel()} words is shorter "
                         f"than the {need} its width table needs")
    if not 0 <= n <= widths.size * chunk:
        raise ValueError(f"{n} elements do not fit {widths.size} chunks of "
                         f"{chunk}")
    return widths


def decode_chunked_stream_plain(body: torch.Tensor, widths, first: int,
                                chunk: int, n: int, zigzag: bool = True,
                                prefix: bool = True) -> torch.Tensor:
    """Plain version of K10 on any device: host ``plane_from_cmajor`` and
    chunk unpack (``algos.chunked.unpack_chunks``), then the un-zigzag and
    the int64 cumsum masked to 32 bits, plus ``first``."""
    from ..algos.chunked import unpack_chunks
    widths = _layout(body, widths, chunk, n)
    words = body.cpu().numpy().view(np.uint32)
    nat = plane_from_cmajor(words, widths, chunk)
    z = unpack_chunks(nat, widths.astype(np.uint8), chunk).reshape(-1)[:n]
    z = torch.from_numpy(z.view(np.int32)).to(body.device)
    if zigzag:
        z = kernels.u32_unzigzag(z)
    if prefix:
        z = kernels.i64_to_u32((kernels.u32_to_i64(cumsum_u32_plain(z)) +
                                (int(first) & kernels.M32)) & kernels.M32)
    return z


def decode_chunked_stream_floats_plain(body: torch.Tensor, widths,
                                       first: int, chunk: int, n: int, key,
                                       depth: int, x0, dx, box,
                                       periodic: bool) -> torch.Tensor:
    """Plain version of K11 on any device: the K10 plain version's bins,
    then ``fastpath.undo_uniform`` (``rng.uniform_dither`` from counter 0
    over the plane, ``kernels.undo_bins``, ``kernels.periodic``)."""
    bins = decode_chunked_stream_plain(body, widths, first, chunk, n)
    return undo_uniform(bins, key, depth, x0, dx, box if periodic else None)


def _check_chunk(chunk: int) -> None:
    if chunk != KERNEL_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel requires chunk == "
                         f"{KERNEL_CHUNK}")


STAGING_SLOTS = 4  # host tables a stream may have in flight


class _Staging:
    """One device and stream's chunk tables: ``STAGING_SLOTS`` pinned host
    slots of ``cap`` words, each with the event after the last copy from
    it, taken in turn, so the host waits on a copy only when the card is
    that many calls behind; and the card's copy, which stream order keeps
    from being rewritten before the kernel before has read it."""

    def __init__(self, index: int, cap: int):
        self.cap = cap
        self.host = torch.empty(STAGING_SLOTS * cap, dtype=torch.int64,
                                pin_memory=True)
        self.table = torch.empty(cap, dtype=torch.int64,
                                 device=torch.device("cuda", index))
        with torch.cuda.device(index):
            self.events = [cuda_lib.lib().mnw_chunked_event()
                           for _ in range(STAGING_SLOTS)]
        if not all(self.events):
            raise RuntimeError("chunked decode: no CUDA event")
        self.turn = 0

    def slot(self) -> tuple:
        """(host address, event) of the next slot."""
        k = self.turn % STAGING_SLOTS
        self.turn += 1
        return self.host.data_ptr() + 8 * self.cap * k, self.events[k]


_staging = {}   # (device index, stream) -> _Staging


def _staging_for(key, need: int) -> _Staging:
    """The staging buffers of one device and stream, grown (after the card
    is done with the old ones) when a plane has more chunks."""
    st = _staging.get(key)
    if st is None or st.cap < need:
        if st is not None:
            torch.cuda.synchronize(key[0])
        st = _staging[key] = _Staging(key[0], max(need, 1024))
    return st


def _launch(body, widths, first, chunk, n, zigzag, prefix, floats,
            key=(0, 0), x0=0.0, dx_bin=0.0, box=0.0, periodic=False):
    """One launch of K10 (``floats`` false) or K11 after one copy of the
    chunk table and one clear of the status words, all in the C entry
    point (``csrc/chunked.cu``)."""
    dev = body.device
    out = torch.empty(n, dtype=torch.float32 if floats else torch.int32,
                      device=dev)
    if n == 0:
        return out
    used = -(-n // chunk)  # later chunks hold no output element
    w8 = np.ascontiguousarray(widths[:used], dtype=np.uint8)
    body = body.contiguous()
    index, stream = cuda_lib.current_stream(dev)
    st = _staging_for((index, stream), used)
    host, event = st.slot()
    words = status_words((index, stream), 1 + -(-n // TILE), dev)
    k0, k1 = (int(k) & kernels.M32 for k in key)
    cuda_lib.launch_on(
        "chunked_decode_floats" if floats else "chunked_decode",
        cuda_lib.lib().mnw_chunked_decode, index, stream, body.data_ptr(),
        w8.ctypes.data, used, host, st.table.data_ptr(), event, n,
        int(zigzag), int(prefix), int(first) & kernels.M32,
        words.data_ptr(), int(floats), k0, k1, float(np.float32(x0)),
        float(dx_bin), float(np.float32(box)), int(periodic),
        out.data_ptr())
    return out


def decode_chunked_stream(body: torch.Tensor, widths, first: int, chunk: int,
                          n: int, zigzag: bool = True,
                          prefix: bool = True) -> torch.Tensor:
    """The first ``n`` elements of a chunked plane: ``body`` the packed
    column-major chunk bodies (int32 tensor of u32 bits), ``widths`` the
    host width table, ``first`` the u32 added to every prefix (the plane's
    element-0 anchor; unused without ``prefix``).  Semantics of the JAX
    package's ``decode_chunked_stream``.  A CUDA tensor launches K10
    (counted in ``decode_chunked_stream.launches``); a CPU tensor runs
    ``decode_chunked_stream_plain``."""
    _check_chunk(chunk)
    widths = _layout(body, widths, chunk, n)
    if body.device.type == "cpu":
        return decode_chunked_stream_plain(body, widths, first, chunk, n,
                                           zigzag, prefix)
    if body.device.type != "cuda":
        raise ValueError(f"no chunked decode for device {body.device}")
    out = _launch(body, widths, first, chunk, n, zigzag, prefix, False)
    decode_chunked_stream.launches += 1
    return out


decode_chunked_stream.launches = 0


def decode_chunked_stream_floats(body: torch.Tensor, widths, first: int,
                                 chunk: int, n: int, key, depth: int, x0, dx,
                                 box, periodic: bool) -> torch.Tensor:
    """The whole float-plane decode of a chunked plane in one pass: K10's
    bins, then the dither of ``key`` (element e uses counter e >> 2),
    ``x0 + dx_bin*(bin + u)`` with ``dx_bin = f32(dx) / 2^depth`` (the
    plane's full range ``dx``), and the rewrap into ``[0, box)`` when
    ``periodic``.  Semantics of the JAX package's
    ``decode_chunked_stream_floats``.  A CUDA tensor launches K11 (counted
    in ``decode_chunked_stream_floats.launches``); a CPU tensor runs
    ``decode_chunked_stream_floats_plain``."""
    _check_chunk(chunk)
    widths = _layout(body, widths, chunk, n)
    if body.device.type == "cpu":
        return decode_chunked_stream_floats_plain(
            body, widths, first, chunk, n, key, depth, x0, dx, box, periodic)
    if body.device.type != "cuda":
        raise ValueError(f"no chunked decode for device {body.device}")
    out = _launch(body, widths, first, chunk, n, True, True, True, key, x0,
                  kernels.bin_width(dx, depth), box, periodic)
    decode_chunked_stream_floats.launches += 1
    return out


decode_chunked_stream_floats.launches = 0
