"""The launch counters of the port's kernels, by the JAX package's kernel
IDs (K1-K12; K13 is K4's kernel).  Each wrapper adds one to its
``launches`` where it launches its CUDA kernel and nowhere else; a suite
sets them to 0 before a run and reads them after it."""

from __future__ import annotations


def counters() -> dict:
    """Kernel ID -> the wrapper that carries its ``launches`` count."""
    from ..ops import chunked_cuda, decode_cuda, encode_cuda, scan_cuda
    return {"K1": decode_cuda.decode_cuda, "K2": decode_cuda.decode_rows_cuda,
            "K3": decode_cuda.unpack_rows_cuda, "K4": encode_cuda.pack_cuda,
            "K5": encode_cuda.encode_recip_cuda,
            "K6": encode_cuda.stats_rows_cuda,
            "K7": encode_cuda.pack_rows_cuda,
            "K8": encode_cuda.encode_recip_rows_cuda,
            "K9": scan_cuda.cumsum_u32,
            "K10": chunked_cuda.decode_chunked_stream,
            "K11": chunked_cuda.decode_chunked_stream_floats,
            "K12": encode_cuda.encode_recip_fused_blocks_cuda}


def reset() -> None:
    for fn in counters().values():
        fn.launches = 0


def read() -> dict:
    """Kernel ID -> launches since the last ``reset``, the kernels that
    launched only."""
    return {k: fn.launches for k, fn in counters().items() if fn.launches}
