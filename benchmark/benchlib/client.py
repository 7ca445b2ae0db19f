"""What the clients of every configuration share: the operation's raw
bytes, the outputs kept for the check, and the check of a written file.

A client (``clients/<name>.py``) holds one configuration's data and calls
the program's entry points; the harness calls ``setup(op)``, ``run(op)``
(one whole operation, returning the bytes it wrote or None), ``forget()``
(drop the warm operation's output), ``check(op, rng)`` and ``close()``.

With ``control`` set, the client is the check's control: the same
operations at the precision below the configuration's f32, its float
fields rounded to bfloat16 where the program takes them in (a write's
input) or hands them out (a read's output), the check unchanged.  A run
of it must come out not correct."""

from __future__ import annotations

import numpy as np
import torch

from . import reference, roofline


class Base:
    def __init__(self, cfg: dict, params: dict, seed: int, device,
                 control: bool = False):
        self.cfg = cfg
        self.params = dict(params)
        self.seed = int(seed)
        self.device = torch.device(device)
        self.control = bool(control)
        self.n = int(cfg["particles"]) + int(cfg.get("padding", 0))
        self.raw_bytes = self.n * roofline.FIELD_BYTES
        self.outputs: list = []
        self.roofline_bytes = None
        self.info: dict = {}            # what set-up learnt, for the log

    def forget(self) -> None:
        self.outputs.clear()

    def close(self) -> None:
        self.outputs.clear()

    def check_written(self, orig: dict, offset: int, rng,
                      head: bytes = b"") -> dict:
        """The numbers of the window's written files: one drawn from the
        seed is decoded by the reference (its blocks, or as many as the
        configuration's ``check_blocks`` drawn from the seed) and compared
        with ``orig``, and every other must equal it byte for byte.
        ``head`` is what must precede the chained segments (``offset``
        bytes)."""
        files = [o.getbuffer() for o in self.outputs]
        pick = files[rng.randrange(len(files))]
        res = {"outputs_differ": sum(1 for f in files
                                     if not same_bytes(f, pick))}
        if bytes(pick[:offset]) != head:
            res["outputs_differ"] = len(files)
        want = None
        if self.cfg.get("check_blocks"):
            blocks = int(self.cfg["blocks"])
            want = set(rng.sample(range(blocks), min(
                blocks, int(self.cfg["check_blocks"]))))
        try:
            count, decoded = reference.decode_file(pick, offset, self.cfg,
                                                   self.device, want)
        except reference.FileError:
            count, decoded = 0, []
        res.update(reference.compare_file(decoded, count, orig, self.cfg))
        del files, pick
        return res


def lower(fields: dict) -> dict:
    """The fields with every float rounded to bfloat16 (the control's
    precision), on their own device."""
    return {k: (v.to(torch.bfloat16).to(v.dtype) if v.is_floating_point()
                else v) for k, v in fields.items()}


def same_bytes(a, b, chunk: int = 1 << 26) -> bool:
    """Whether two buffers hold the same bytes, compared in chunks."""
    x = np.frombuffer(a, dtype=np.uint8)
    y = np.frombuffer(b, dtype=np.uint8)
    if x.shape != y.shape:
        return False
    return all(np.array_equal(x[i:i + chunk], y[i:i + chunk])
               for i in range(0, x.shape[0], chunk))
