"""Chunked-width bitstream helpers of the Coil, Octo and Sort codecs.

Port of ``minnow_c_tpu/algos/chunked.py``.  Chunks of ``CHUNK`` elements
pack at per-chunk widths, each chunk starting on a u32 word boundary (CHUNK
is a multiple of 32, so a chunk at width w is exactly ``CHUNK*w/32``
words).

Host functions (numpy; the pack and unpack through ``ops.native``, the JAX
package's C++ built read-only): ``chunk_widths``, ``pack_chunks``,
``unpack_chunks``, ``total_words``.  Device functions (torch tensors on the
data's device): ``chunk_widths_device``, ``pack_chunks_device`` (one rows
pack per width bucket, K7 on CUDA) and ``unpack_chunks_device`` (one rows
unpack per bucket, K3 on CUDA).  The ``_auto`` dispatchers take the device
path for a CUDA tensor and the host path otherwise; the bytes and values are
identical either way.

Two TPU answers are not carried over: the power-of-two bucket padding (it
bounded the set of compiled XLA programs) and ``_MAX_DEVICE_WIDTHS = 8``,
which sent width-diverse streams to the host C++ because every distinct
width cost the TPU a compile.  The CUDA kernels take the width at run time,
so every stream on the card takes the device path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import native
from ..ops.decode_cuda import unpack_rows_cuda
from ..ops.encode_cuda import pack_rows_cuda
from ..ops.kernels import u32_to_i64

CHUNK = 256


def _offsets(widths: np.ndarray, chunk: int) -> np.ndarray:
    """Word offset of every chunk, and the total as the last entry."""
    wpc = (chunk * widths.astype(np.int64)) // 32
    return np.concatenate([[0], np.cumsum(wpc)]).astype(np.int64)


def _unpack_offsets(n_words: int, widths: np.ndarray,
                    chunk: int) -> np.ndarray:
    """``_offsets`` of a wire-sourced width table, which a malformed stream
    fails cleanly: a width above 32 or a body too short for the table
    raises ValueError."""
    if widths.shape[0] and int(widths.max()) > 32:
        raise ValueError(
            f"chunk width {int(widths.max())} > 32 in stream width table")
    offs = _offsets(widths, chunk)
    if n_words < int(offs[-1]):
        raise ValueError(f"chunk body of {n_words} words is shorter than "
                         f"the {int(offs[-1])} its width table needs")
    return offs


# ---------------------------------------------------------------------------
# Host (numpy)
# ---------------------------------------------------------------------------

def chunk_widths(z: np.ndarray, chunk: int = CHUNK
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Split a u32 stream into (n_chunks, chunk) rows (zero-padded) and
    per-chunk bit widths."""
    n = z.shape[0]
    n_chunks = -(-n // chunk)
    zp = np.zeros(n_chunks * chunk, dtype=np.uint32)
    zp[:n] = z
    zc = zp.reshape(n_chunks, chunk)
    maxes = zc.max(axis=1)
    # bit_length(m) == ceil(log2(m + 1)); exact in f64 for all u32 (the
    # JAX package's host formula, kept so the bytes stay its bytes)
    widths = np.ceil(np.log2(maxes.astype(np.float64) + 1.0)).astype(
        np.uint8)
    return zc, widths


def pack_chunks(zc: np.ndarray, widths: np.ndarray) -> bytes:
    """Pack each chunk row at its width; returns the concatenated
    word-aligned chunk bodies as bytes (in chunk order)."""
    from ..utils.debug import debug_assert
    n_chunks = zc.shape[0]
    debug_assert(widths.shape[0] == n_chunks, "widths/chunks mismatch")
    debug_assert(
        lambda: n_chunks == 0 or bool((
            ((zc.max(axis=1) >> np.minimum(widths, 31).astype(np.uint32))
             == 0) | (widths.astype(np.int64) >= 32)).all()),
        "chunk value exceeds declared width")
    chunk = int(zc.shape[1]) if n_chunks else CHUNK
    offs = _offsets(widths, chunk)
    body = np.zeros(int(offs[-1]), dtype=np.uint32)
    for wv in np.unique(widths):
        if wv == 0:
            continue
        idx = np.nonzero(widths == wv)[0]
        wpc = chunk * int(wv) // 32
        # same-width chunks are word-aligned: their rows pack as one stream
        packed = native.uniform_pack_host(zc[idx].reshape(-1), int(wv))
        body[offs[idx][:, None] + np.arange(wpc)] = packed.reshape(-1, wpc)
    return body.astype("<u4", copy=False).tobytes()


def unpack_chunks(body: np.ndarray, widths: np.ndarray,
                  chunk: int = CHUNK) -> np.ndarray:
    """Inverse of pack_chunks: ``body`` is the concatenated u32 words,
    ``widths`` the per-chunk widths.  Returns (n_chunks, chunk) u32."""
    n_chunks = widths.shape[0]
    offs = _unpack_offsets(body.shape[0], widths, chunk)
    out = np.zeros((n_chunks, chunk), dtype=np.uint32)
    for wv in np.unique(widths):
        if wv == 0:
            continue
        idx = np.nonzero(widths == wv)[0]
        wpc = chunk * int(wv) // 32
        rows = body[offs[idx][:, None] + np.arange(wpc)]  # (m, wpc)
        vals = native.uniform_unpack_host(
            np.ascontiguousarray(rows.reshape(-1)), int(wv),
            len(idx) * chunk)
        out[idx] = vals.reshape(-1, chunk)
    return out


def total_words(widths: np.ndarray, chunk: int = CHUNK) -> int:
    return int(((chunk * widths.astype(np.int64)) // 32).sum())


# ---------------------------------------------------------------------------
# Device (torch; the rows kernels on CUDA)
# ---------------------------------------------------------------------------

def _bit_widths_device(maxes: torch.Tensor) -> torch.Tensor:
    """bit_length of each u32 value (int64 input), exactly: the count of
    thresholds 2^k - 1 (k = 0..31) it exceeds; no float round trip."""
    thresh = (torch.ones(32, dtype=torch.int64, device=maxes.device)
              << torch.arange(32, device=maxes.device)) - 1
    return (maxes[:, None] > thresh[None, :]).sum(dim=1)


def chunk_widths_device(z: torch.Tensor, chunk: int = CHUNK):
    """Device analog of ``chunk_widths``: z (n,) u32 bits (int32) ->
    (zc (n_chunks, chunk) on z's device, widths (n_chunks,) host u8).  One
    small device-to-host copy: the width table, which goes into the wire
    payload anyway."""
    n = z.shape[0]
    n_chunks = -(-n // chunk)
    zc = torch.nn.functional.pad(z, (0, n_chunks * chunk - n)).reshape(
        n_chunks, chunk)
    maxes = u32_to_i64(zc).amax(dim=1)
    return zc, _bit_widths_device(maxes).cpu().numpy().astype(np.uint8)


def pack_chunks_device(zc: torch.Tensor, widths: np.ndarray) -> bytes:
    """Device ``pack_chunks``: zc (n_chunks, chunk) u32 bits on the device,
    widths host u8.  Each width bucket's rows pack in one rows-pack call
    and scatter to their chunks' offsets; byte-identical output."""
    n_chunks = zc.shape[0]
    if n_chunks == 0:
        return b""
    chunk = zc.shape[1]
    offs = _offsets(widths, chunk)
    body = torch.zeros(int(offs[-1]), dtype=torch.int32, device=zc.device)
    for wv in np.unique(widths):
        if wv == 0:
            continue
        idx = np.nonzero(widths == wv)[0]
        wpc = chunk * int(wv) // 32
        packed = pack_rows_cuda(zc[torch.from_numpy(idx).to(zc.device)],
                                int(wv))
        dst = offs[idx][:, None] + np.arange(wpc)
        body[torch.from_numpy(dst.reshape(-1)).to(zc.device)] = \
            packed.reshape(-1)
    return body.cpu().numpy().view(np.uint32).astype(
        "<u4", copy=False).tobytes()


def unpack_chunks_device(body: torch.Tensor, widths: np.ndarray,
                         chunk: int = CHUNK) -> torch.Tensor:
    """Device ``unpack_chunks``: ``body`` u32 words (int32 tensor) on the
    device, ``widths`` the host u8 table.  Returns (n_chunks, chunk) u32
    bits on body's device, value-identical to ``unpack_chunks``."""
    n_chunks = widths.shape[0]
    offs = _unpack_offsets(body.numel(), widths, chunk)
    out = torch.zeros((n_chunks, chunk), dtype=torch.int32,
                      device=body.device)
    for wv in np.unique(widths):
        if wv == 0:
            continue
        idx = np.nonzero(widths == wv)[0]
        wpc = chunk * int(wv) // 32
        src = torch.from_numpy(offs[idx][:, None] + np.arange(wpc)).to(
            body.device)
        out[torch.from_numpy(idx).to(body.device)] = unpack_rows_cuda(
            body[src], int(wv), chunk)
    return out


def chunk_widths_auto(z: torch.Tensor, chunk: int = CHUNK):
    """``chunk_widths_device`` for a CUDA tensor (zc stays on the card),
    ``chunk_widths`` on its numpy view otherwise."""
    if z.is_cuda:
        return chunk_widths_device(z, chunk)
    return chunk_widths(z.numpy().view(np.uint32), chunk)


def pack_chunks_auto(zc, widths: np.ndarray) -> bytes:
    """``pack_chunks_device`` for a CUDA tensor, ``pack_chunks`` for host
    rows; identical bytes."""
    if isinstance(zc, torch.Tensor) and zc.is_cuda:
        return pack_chunks_device(zc, widths)
    return pack_chunks(np.asarray(zc), widths)


def unpack_chunks_auto(body: torch.Tensor, widths: np.ndarray,
                       chunk: int = CHUNK) -> torch.Tensor:
    """``unpack_chunks_device`` for a CUDA tensor, ``unpack_chunks`` on the
    host for a CPU one; (n_chunks, chunk) u32 bits on body's device."""
    if body.is_cuda:
        return unpack_chunks_device(body, widths, chunk)
    vals = unpack_chunks(body.numpy().view(np.uint32), widths, chunk)
    return torch.from_numpy(vals.view(np.int32))


def pack_cmajor(z: torch.Tensor, chunk: int):
    """A u32 stream (int32 bits) -> (widths, the packed chunk bodies in the
    column-major wire layout of Coil v1.1 and Sort v1.2, host u32 words)."""
    from ..ops.chunked_cuda import plane_to_cmajor
    zc, widths = chunk_widths_auto(z, chunk)
    natural = np.frombuffer(pack_chunks_auto(zc, widths), dtype="<u4")
    return widths, plane_to_cmajor(natural, widths, chunk)


def unpack_cmajor(body: np.ndarray, widths: np.ndarray, chunk: int, n: int,
                  device) -> torch.Tensor:
    """Inverse of ``pack_cmajor`` by the generic route (natural layout on
    the host, chunk unpack on ``device``): the first ``n`` values, int32
    bits."""
    from ..ops.chunked_cuda import plane_from_cmajor
    nat = plane_from_cmajor(np.ascontiguousarray(body), widths, chunk)
    words = torch.from_numpy(nat.view(np.int32)).to(device)
    return unpack_chunks_auto(words, widths, chunk).reshape(-1)[:n]
