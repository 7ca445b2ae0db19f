"""The Gadget-2 driver's client, as the CLI calls it: a format-1 file in
host memory compressed with ``drivers.gadget2.compress``, or a ``.g2.min``
file decompressed back to a Gadget-2 file with
``drivers.gadget2.decompress``, both into in-memory files."""

from __future__ import annotations

import io

import numpy as np
import torch

from minnow_c_tpu_torch.drivers import gadget2 as driver
from benchlib import datagen, gadget2, reference, roofline
from benchlib.client import Base, lower, same_bytes


class Client(Base):
    def setup(self, op: str) -> None:
        fields = datagen.make_particles(self.cfg, self.seed, self.device)
        given = lower(fields) if self.control and op == "write" else fields
        host = {k: v.cpu().numpy() for k, v in fields.items()}
        self.head = gadget2.header(self.cfg)
        self.g2 = gadget2.build(self.head, host["pos"], host["vel"],
                                host["ids"])
        self.given = self.g2
        if given is not fields:
            self.given = gadget2.build(self.head, given["pos"].cpu().numpy(),
                                       given["vel"].cpu().numpy(),
                                       host["ids"])
        del host, fields, given
        if op == "read":
            out = io.BytesIO()
            self.info = driver.compress(io.BytesIO(self.g2), out,
                                        device=self.device, **self.params)
            self.min = out.getvalue()

    def run(self, op: str):
        out = io.BytesIO()
        if op == "write":
            self.info = driver.compress(io.BytesIO(self.given), out,
                                        device=self.device, **self.params)
        else:
            driver.decompress(io.BytesIO(self.min), out, device=self.device)
            if self.control:
                out = self._lowered(out)
        self.outputs.append(out)
        return out.tell() if op == "write" else None

    def _lowered(self, out: io.BytesIO) -> io.BytesIO:
        head, pos, vel, ids = gadget2.parse(out.getbuffer())
        low = lower({"pos": torch.from_numpy(pos.copy()),
                     "vel": torch.from_numpy(vel.copy())})
        return io.BytesIO(gadget2.build(head, low["pos"].numpy(),
                                        low["vel"].numpy(), ids.copy()))

    def _orig(self) -> dict:
        _, pos, vel, ids = gadget2.parse(self.g2)
        return {"pos": torch.from_numpy(np.ascontiguousarray(pos)).to(
                    self.device),
                "vel": torch.from_numpy(np.ascontiguousarray(vel)).to(
                    self.device),
                "ids": torch.from_numpy(ids.view(np.int64).copy()).to(
                    self.device)}

    def check(self, op: str, rng) -> dict:
        record = 4 + gadget2.HEADER_BYTES + 4
        orig = self._orig()
        self.roofline_bytes = roofline.least_bytes(orig, self.cfg)
        if op == "write":
            return self.check_written(orig, record, rng,
                                      head=bytes(self.g2[:record]))
        files = [o.getbuffer() for o in self.outputs]
        pick = files[rng.randrange(len(files))]
        try:
            head, pos, vel, ids = gadget2.parse(pick)
        except ValueError:                  # not a Gadget-2 file at all
            return {"count_off": self.n, "outputs_differ": len(files)}
        out = {"pos": torch.from_numpy(np.ascontiguousarray(pos)),
               "vel": torch.from_numpy(np.ascontiguousarray(vel)),
               "ids": torch.from_numpy(ids.view(np.int64).copy())}
        res = reference.compare_fields(out, orig, self.cfg)
        res["outputs_differ"] = sum(1 for f in files
                                    if not same_bytes(f, pick))
        if head != self.head:
            res["outputs_differ"] = len(files)
        del out, pos, vel, ids, files, pick
        return res

    def close(self) -> None:
        super().close()
        self.g2 = self.given = self.min = None
