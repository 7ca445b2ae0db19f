"""The plain reference: a reader of minnow snapshot files written from the
public layout, and the comparisons that decide ``correct``.

It imports nothing of the program.  The file layout it reads:

* a chain of 48-byte IOHeaders (u32 magic ``Mnw\\0``, u32 version, 3 f32
  origin, 3 f32 width, u64 segment bytes, u64 absolute offset of the next
  header, 0 at the end), each followed by its segment;
* a segment: u32 checksum, i32 block count, i32 field count, i32 particle
  count; per field u32 code, u32 algorithm, u32 version, i32 block count;
  per block i32 length, u32 checksum; then the blocks;
* a block: u32 raw length, u32 stored length, u8 bit width, u8 flags
  (bit 0: LZ4), u16, u32, then the stored payload;
* a Trim field: a metadata block, then one block of packed bins per
  dimension (bit b of element i at bit i*width + b of a little-endian
  stream of u32 words).

Float fields: metadata x0[3], x1[3] (f32), for positions the box (f32),
then u8 depth, u8 per-particle flag (0 here), ..., u64 seed.  The shared
range is m = max_d f32(x1_d - x0_d); dimension d's range is
f32(x0_d + m) - x0_d and its bin width that over 2^depth.  A decode may
put a value anywhere in its bin (the dither), so the reference takes the
worst of the bin's two edges: the widest error any decode of these bins
could show.  IDs: metadata u64 grid width, u64 x0[3], u64 x1[3]; the
coordinate x0_d + bin, less the width when it reaches it, and the ID
x + W*(y + W*z) mod 2^64.

The comparisons give numbers in units of the configuration's accuracies
(positions by periodic distance), each held to its limit in ``LIMITS``:
the configuration states the accuracy, so a float error is within it below
1; IDs and particle counts are exact."""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import lz4

MAGIC = 0x00776E4D
IO_HEADER = struct.Struct("<II3f3fQQ")


def fourcc(s: str) -> int:
    return int.from_bytes(s.encode(), "big")


POSN, VELC, PTID, TRIM = (fourcc("Posn"), fourcc("Velc"), fourcc("Ptid"),
                          fourcc("Trim"))

# The limits of the numbers compared: the accuracies the configuration
# states (an error of at most 1 accuracy) and exact IDs, counts and
# bytes.
LIMITS = {"pos_err": 1.0, "vel_err": 1.0, "ids_wrong": 0, "count_off": 0,
          "outputs_differ": 0}


class FileError(ValueError):
    """The file does not have the layout the configuration's writer
    gives."""


def segments(data, offset: int = 0) -> list:
    """The segments of a chained file from ``offset``, as memoryviews."""
    view = memoryview(data)
    out = []
    while True:
        if offset + IO_HEADER.size > len(view):
            raise FileError("truncated IOHeader chain")
        magic, _, *_geom, nbytes, nxt = IO_HEADER.unpack_from(view, offset)
        if magic != MAGIC:
            raise FileError(f"bad magic {magic:#x} at {offset}")
        start = offset + IO_HEADER.size
        if start + nbytes > len(view):
            raise FileError("truncated segment")
        out.append(view[start:start + nbytes])
        if nxt == 0:
            return out
        if nxt <= offset:
            raise FileError("IOHeader chain does not advance")
        offset = nxt


def parse_segment(seg) -> tuple:
    """(particle count, {field code: (algorithm, [block views])})."""
    checksum, nblocks, nfields, nparts = struct.unpack_from("<Iiii", seg, 0)
    off = 16
    fields = []
    for _ in range(nfields):
        code, algo, _version, nb = struct.unpack_from("<IIIi", seg, off)
        fields.append((code, algo, nb))
        off += 16
    lengths = []
    for _ in range(nblocks):
        length, _sum = struct.unpack_from("<iI", seg, off)
        lengths.append(length)
        off += 8
    out, bi = {}, 0
    for code, algo, nb in fields:
        blocks = []
        for _ in range(nb):
            blocks.append(seg[off:off + lengths[bi]])
            off += lengths[bi]
            bi += 1
        out[code] = (algo, blocks)
    if off != len(seg):
        raise FileError(f"segment holds {len(seg)} bytes, blocks end at "
                        f"{off}")
    return nparts, out


def payload(block) -> tuple:
    """(payload bytes, bit width) of a block."""
    raw_len, stored, width, flags = struct.unpack_from("<IIBB", block, 0)
    body = bytes(block[16:16 + stored])
    if flags & 1:
        return lz4.decode(body, raw_len), width
    if flags or stored != raw_len:
        raise FileError(f"block flags {flags:#x}, {stored} of {raw_len} B")
    return body, width


def unpack(data: bytes, width: int, n: int, device) -> torch.Tensor:
    """n values of ``width`` bits from a packed stream, as int64."""
    words = torch.from_numpy(np.frombuffer(data, dtype="<u4").astype(
        np.int64)).to(device)
    if words.numel() * 32 < n * width:
        raise FileError(f"{words.numel()} words cannot hold {n} values "
                        f"of {width} bits")
    words = torch.cat([words, words.new_zeros(1)])
    bit = torch.arange(n, dtype=torch.int64, device=device) * width
    pair = words[bit >> 5] | (words[(bit >> 5) + 1] << 32)
    return (pair >> (bit & 31)) & ((1 << width) - 1)


def _float_meta(meta: bytes, is_pos: bool) -> tuple:
    x0 = np.frombuffer(meta, dtype="<f4", count=3, offset=0)
    x1 = np.frombuffer(meta, dtype="<f4", count=3, offset=12)
    depth, per_particle = meta[28 if is_pos else 24], \
        meta[29 if is_pos else 25]
    if per_particle:
        raise FileError("per-particle depths are not this writer's")
    if not is_pos and meta[26]:
        raise FileError("a mapped velocity field is not this writer's")
    m = np.max(x1 - x0).astype(np.float32)
    rng = (np.float32(x0 + m) - x0).astype(np.float32)
    return x0.astype(np.float64), rng.astype(np.float64), depth


def _i64(v: int) -> int:
    """A u64 value as the int64 of the same bits (products then wrap
    mod 2^64 as u64 arithmetic does)."""
    v %= 1 << 64
    return v - (1 << 64) if v >= 1 << 63 else v


def _dist(a: torch.Tensor, b: torch.Tensor, box) -> torch.Tensor:
    d = (a - b).abs()
    if box:
        d = torch.remainder(d, box)
        d = torch.minimum(d, box - d)
    return d


def decode_file(data, offset: int, cfg: dict, device,
                want_blocks=None) -> tuple:
    """(particles in the file, decoded blocks) of a snapshot file: every
    block, or those numbered in ``want_blocks``, as dicts of "index",
    "n", "pos" / "vel" (per dimension: bin low edges f64, bin width) and
    "ids" int64."""
    segs = segments(data, offset)
    total = sum(struct.unpack_from("<i", s, 12)[0] for s in segs)
    out = []
    for i, seg in enumerate(segs):
        if want_blocks is not None and i not in want_blocks:
            continue
        n, fields = parse_segment(seg)
        blk = {"index": i, "n": n}
        for code, name in ((POSN, "pos"), (VELC, "vel")):
            algo, blocks = fields[code]
            if algo != TRIM or len(blocks) != 4:
                raise FileError(f"{name}: algorithm {algo:#x}, "
                                f"{len(blocks)} blocks")
            x0, rng, depth = _float_meta(payload(blocks[0])[0],
                                         code == POSN)
            dims = []
            for d in range(3):
                data_d, width = payload(blocks[1 + d])
                if width != depth:
                    raise FileError(f"{name}[{d}] width {width} != depth "
                                    f"{depth}")
                bins = unpack(data_d, width, n, device)
                bw = rng[d] / float(1 << depth)
                dims.append((x0[d] + bw * bins.to(torch.float64), bw))
            blk[name] = dims
        algo, blocks = fields[PTID]
        meta = payload(blocks[0])[0]
        grid = struct.unpack_from("<Q", meta, 0)[0]
        x0 = struct.unpack_from("<3Q", meta, 8)
        ids = None
        for d in range(3):
            data_d, width = payload(blocks[1 + d])
            v = unpack(data_d, width, n, device) + _i64(x0[d])
            v = torch.where(v >= grid, v - grid, v)
            term = v * _i64(grid ** d)
            ids = term if ids is None else ids + term
        blk["ids"] = ids
        out.append(blk)
    return total, out


def block_of(arr: torch.Tensor, index: int, nb: int) -> torch.Tensor:
    return arr[..., index * nb:(index + 1) * nb]


def compare_file(decoded: list, total: int, orig: dict, cfg: dict) -> dict:
    """The numbers of a file's decoded blocks against the original
    particles (device tensors ``pos``, ``vel`` (3, n), ``ids`` (n,));
    ``total`` is the file's particle count."""
    acc = cfg["accuracy"]
    box = float(cfg["box"])
    n = orig["ids"].shape[0]
    nb = n // int(cfg["blocks"])
    res = {"pos_err": 0.0, "vel_err": 0.0, "ids_wrong": 0,
           "count_off": abs(total - n)}
    for blk in decoded:
        if blk["n"] != nb or blk["index"] >= int(cfg["blocks"]):
            res["count_off"] = max(res["count_off"], 1)
            continue
        for name, period in (("pos", box), ("vel", 0.0)):
            o = block_of(orig[name], blk["index"], nb).to(torch.float64)
            worst = 0.0
            for d, (lo, bw) in enumerate(blk[name]):
                e = torch.maximum(_dist(o[d], lo, period),
                                  _dist(o[d], lo + bw, period))
                worst = max(worst, float(e.max()))
            res[f"{name}_err"] = max(res[f"{name}_err"],
                                     worst / float(acc[name]))
        res["ids_wrong"] += int((blk["ids"] != block_of(
            orig["ids"], blk["index"], nb)).sum())
    return res


def compare_fields(out: dict, orig: dict, cfg: dict,
                   chunk: int = 1 << 24) -> dict:
    """The numbers of decoded fields (``pos``, ``vel`` (3, n) f32,
    ``ids`` (n,) int64, on any device) against the original particles,
    compared in chunks of particles on the original's device."""
    acc = cfg["accuracy"]
    box = float(cfg["box"])
    n = orig["ids"].shape[0]
    got = int(out["ids"].shape[0]) if "ids" in out else 0
    have = min(got, n)
    res = {"pos_err": 0.0, "vel_err": 0.0, "ids_wrong": 0,
           "count_off": abs(n - got)}
    dev = orig["ids"].device
    for name, period in (("pos", box), ("vel", 0.0)):
        if name not in out or out[name].shape[-1] < have:
            res["count_off"] = n
            continue
        worst = 0.0
        for s in range(0, have, chunk):
            e = min(s + chunk, have)
            a = out[name][:, s:e].to(dev, torch.float64)
            b = orig[name][:, s:e].to(torch.float64)
            worst = max(worst, float(_dist(a, b, period).max()))
        res[f"{name}_err"] = worst / float(acc[name])
    for s in range(0, have, chunk):
        e = min(s + chunk, have)
        res["ids_wrong"] += int((out["ids"][s:e].to(dev) !=
                                 orig["ids"][s:e]).sum())
    return res
