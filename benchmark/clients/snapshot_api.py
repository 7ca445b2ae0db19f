"""The in-process client of a GPU code: its fields are device tensors,
written with ``compress_snapshot`` into an in-memory file, or read back
onto the card with ``decompress_snapshot``."""

from __future__ import annotations

import io

import torch

import minnow_c_tpu_torch as mt
from benchlib import datagen, reference, roofline
from benchlib.client import Base, lower


class Client(Base):
    def _spec(self):
        acc = self.cfg["accuracy"]
        return mt.SnapshotSpec(
            pos=mt.PositionAccuracy(delta=float(acc["pos"]),
                                    width=float(self.cfg["box"])),
            vel=mt.VelocityAccuracy(delta=float(acc["vel"])),
            ids=mt.IDAccuracy(width=int(self.cfg["generator"]["lattice"])))

    def _write(self, fields) -> io.BytesIO:
        params = {"scale_mode": self.cfg["accuracy"]["scale_mode"],
                  **self.params}
        fp = io.BytesIO()
        self.info = mt.compress_snapshot(
            fp, fields["pos"], fields["vel"], fields["ids"], self._spec(),
            num_blocks=int(self.cfg["blocks"]), seed=self.seed,
            device=self.device, **params)
        return fp

    def setup(self, op: str) -> None:
        fields = datagen.make_particles(self.cfg, self.seed, self.device)
        if op == "write":
            self.fields = fields
            self.given = lower(fields) if self.control else fields
        else:
            self.file = self._write(fields).getvalue()
            del fields
        self.last = None
        self.prints = []

    def run(self, op: str):
        if op == "write":
            fp = self._write(self.given)
            self.outputs.append(fp)
            return fp.tell()
        if self.last is not None:
            self.prints.append(fingerprint(self.last))
            self.last = None
        self.last = mt.decompress_snapshot(io.BytesIO(self.file),
                                           device=self.device,
                                           **self.params)
        if self.control:
            self.last = lower(self.last)
        return None

    def forget(self) -> None:
        super().forget()
        self.last = None
        self.prints = []

    def check(self, op: str, rng) -> dict:
        if op == "write":
            self.given = None
            self.roofline_bytes = roofline.least_bytes(self.fields,
                                                       self.cfg)
            return self.check_written(self.fields, 0, rng)
        last = self.last
        self.last = None
        prints = [[int(v) for v in p] for p in self.prints]
        mine = [int(v) for v in fingerprint(last)]
        self.file = None
        orig = datagen.make_particles(self.cfg, self.seed, self.device)
        self.roofline_bytes = roofline.least_bytes(orig, self.cfg)
        res = reference.compare_fields(last, orig, self.cfg)
        res["outputs_differ"] = sum(1 for p in prints if p != mine)
        return res

    def close(self) -> None:
        super().close()
        self.fields = self.given = self.last = self.file = None


def fingerprint(out: dict) -> list:
    """Sums of a read's fields as 32-bit words, on the card: equal reads
    give equal sums."""
    return [torch.sum(out[k].contiguous().view(torch.int32),
                      dtype=torch.int64) for k in sorted(out)]
