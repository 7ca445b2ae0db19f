"""The yardstick of the kernels' roofline: the card's peak memory
bandwidth and the least bytes an operation must move.

The least bytes are those of the work, whatever kernels do it and whatever
widths the program picks: a write reads its raw fields once and writes the
packed bins once; a read reads the packed bins once and writes the decoded
fields once.  The packed bins are counted here from the original
particles and the configuration alone: per block and dimension, the fewest
bits that tell apart the bins of the stated accuracy across the block's
extent (positions on the periodic box, IDs on the lattice ring)."""

from __future__ import annotations

import math

import torch

# Published HBM bandwidth (NVIDIA's data sheets), by torch's device name.
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # SXM5
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}

FIELD_BYTES = 3 * 4 + 3 * 4 + 8     # f32 pos and vel, u64 IDs a particle


def peak_bytes_per_s(device_name: str):
    """The card's peak bandwidth, or None for a card not in the table."""
    return PEAK_BYTES_PER_S.get(device_name)


def extent(v: torch.Tensor, period=None) -> float:
    """Length of the shortest interval that holds every value of ``v``:
    on a line, or on a ring of length ``period``."""
    if v.numel() < 2:
        return 0.0
    if period is None:
        return float(v.max() - v.min())
    s = torch.sort(v).values
    widest = max(float(torch.diff(s).max()),
                 float(s[0]) + period - float(s[-1]))
    return max(0.0, period - widest)


def bits_for(count: float) -> int:
    """Bits that tell ``count`` values apart (0 for one or none)."""
    return max(0, math.ceil(math.log2(count))) if count > 1 else 0


def block_bits(orig: dict, cfg: dict, index: int) -> int:
    """Least bits a particle of block ``index``: each float dimension its
    bins of the stated accuracy across its extent, each ID coordinate
    (x, y, z on the lattice of the configuration's generator) its values
    across its extent on the ring."""
    n = orig["ids"].shape[0]
    nb = n // int(cfg["blocks"])
    sl = slice(index * nb, (index + 1) * nb)
    acc = cfg["accuracy"]
    box = float(cfg["box"])
    bits = 0
    for name, period in (("pos", box), ("vel", None)):
        for d in range(3):
            span = extent(orig[name][d, sl].to(torch.float64), period)
            bits += bits_for(math.ceil(span / float(acc[name])))
    grid = int(cfg["generator"]["lattice"])
    ids = orig["ids"][sl]
    for d in range(3):
        coord = (ids // grid ** d) % grid
        bits += bits_for(extent(coord.to(torch.float64), grid) + 1)
    return bits


def least_bytes(orig: dict, cfg: dict) -> float:
    """Least bytes an operation of the configuration moves: the raw
    fields of ``orig`` once and their packed bins once."""
    n = orig["ids"].shape[0]
    nb = n // int(cfg["blocks"])
    packed = sum(block_bits(orig, cfg, b) * nb
                 for b in range(int(cfg["blocks"]))) / 8
    return n * FIELD_BYTES + packed
