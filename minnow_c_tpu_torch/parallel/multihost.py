"""Multi-process (multi-host) setup for the block-sharded codecs, over
``torch.distributed`` with the gloo backend.

Port of ``minnow_c_tpu/parallel/multihost.py``.  Every process calls
``initialize()`` to join one process group; each holds a contiguous slice
of the global block axis (process p the blocks ``[p*B_local,
(p+1)*B_local)``) in a :class:`BlockShards` container, which the sharded
codecs (``sharding.py``) take in place of a plain tensor: they key each
block's dither by its global index and reduce their headers over the
processes through the collectives below.  Each process writes or reads
the segments of its own blocks (``snapshot.compress_snapshot_multihost``,
``decompress_snapshot_multihost``).

The collectives carry host bytes and scalars only (header ranges, ID
frames, serialized segments), as ``process_allgather`` of numpy does in
the JAX package, so gloo serves on any machine: NCCL would need a card
for every rank, and one card may hold several ranks.  Every helper is a
no-op for a single process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class BlockShards:
    """This process's contiguous slice of an array whose leading axis is
    sharded over the processes: ``local`` holds entries ``[first, first +
    len(local))`` of a global leading axis of ``total`` entries.  The
    leading axis is the blocks of a (B, ...) array, or the rows of a
    block-major (B*3, n) rows array (the sharded codecs count a block as
    three rows there)."""

    local: torch.Tensor
    first: int
    total: int


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the gloo process group at ``coordinator_address``
    (``host:port``, or a ``tcp://`` URL); a no-op for a single process."""
    url = coordinator_address
    if url is not None and "://" not in url:
        url = f"tcp://{url}"
    if coordinator_address is not None and num_processes is None:
        # Forward rather than silently staying single-process (every
        # process would then build its own disjoint "global" array with no
        # error): torch reads the size and rank from the URL's query, or
        # refuses.
        dist.init_process_group(
            "gloo", init_method=url,
            rank=-1 if process_id is None else process_id)
        return
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group("gloo", init_method=url,
                            world_size=num_processes,
                            rank=-1 if process_id is None else process_id)


def host_tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same bits: u32 words as int32,
    u64 values as int64 (the port's conventions)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch takes writable arrays only
        a = a.copy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a)


def global_block_array(local_blocks, mesh) -> BlockShards:
    """This process's contiguous slice of the global block axis as a
    :class:`BlockShards` on the mesh's first device; every process passes
    the same count (``make_array_from_process_local_data`` in the JAX
    package).  Numpy u64 arrays become int64 tensors of the same bits."""
    if not isinstance(local_blocks, torch.Tensor):
        local_blocks = host_tensor(local_blocks)
    k = local_blocks.shape[0]
    return BlockShards(local_blocks.to(mesh.devices[0]),
                       process_index() * k, process_count() * k)


def local_block_slice(global_out, mesh=None) -> np.ndarray:
    """This process's slice of a block-sharded result, as a numpy array in
    global block order (int64 tensors stay int64: u64 bits).  ``mesh`` is
    taken for the JAX package's signature: a container holds only this
    process's blocks, one copy of each."""
    if isinstance(global_out, BlockShards):
        global_out = global_out.local
    return global_out.cpu().numpy()


def _allgather(t: torch.Tensor) -> List[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t.contiguous())
    return out


def allgather_max_f32(x: float) -> float:
    """The largest of every process's f32 scalar (the one sync the shared
    depth needs; quant.c:195 analog), NaN if any is NaN."""
    if process_count() <= 1:
        return float(np.float32(x))
    g = _allgather(torch.tensor([np.float32(x)], dtype=torch.float32))
    return float(np.float32(np.max(torch.cat(g).numpy())))


def allgather_i64(arr) -> np.ndarray:
    """Every process's int64 array of one shape, as (P, *shape) rank-major.
    Single-process: (1, *shape) view of the input."""
    arr = np.asarray(arr, dtype=np.int64)
    if process_count() <= 1:
        return arr[None]
    return torch.stack(_allgather(host_tensor(arr))).numpy()


def allgather_bytes(blobs: Sequence[bytes]) -> List[bytes]:
    """Every process's list of byte strings, concatenated rank-major
    (process 0's first).  Every process passes a list of the same length:
    one count gather, one length gather, one gather of the blobs padded to
    the longest."""
    if process_count() <= 1:
        return list(blobs)
    counts = _allgather(torch.tensor([len(blobs)], dtype=torch.int64))
    if any(int(c) != len(blobs) for c in counts):
        raise ValueError("allgather_bytes requires equal blob counts on "
                         "every process")
    lens = torch.stack(_allgather(torch.tensor([len(b) for b in blobs],
                                               dtype=torch.int64)))
    lmax = int(lens.max()) if lens.numel() else 0
    pad = np.zeros((len(blobs), lmax), dtype=np.uint8)
    for i, b in enumerate(blobs):
        pad[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    allb = _allgather(torch.from_numpy(pad))
    return [allb[p][i, :int(lens[p, i])].numpy().tobytes()
            for p in range(len(allb)) for i in range(len(blobs))]


def barrier(name: str = "minnow") -> None:
    """Cross-process barrier (the file-visibility fence around writes);
    ``name`` is taken for the JAX package's signature."""
    if process_count() > 1:
        dist.barrier()
