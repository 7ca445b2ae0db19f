"""``python -m minnow_c_tpu_torch.bench {headline,kernels,codecs,matrix}
[names...] [--records PATH] [--device cuda|cpu]``

* ``headline``: the one JSON line of ``bench.py``'s schema (K1 decode);
* ``kernels [workloads...]``: the kernel suite (``kernel_suite.NAMES``);
* ``codecs [codecs...]``: the six codecs end to end, and
  ``device_decode`` for the delta family's device phases (all by
  default);
* ``matrix [configs...]``: the BASELINE configs (``matrix.CONFIGS``).

Sizes are the JAX benchmark scripts'.  Results go to the records file
(default ``bench_torch.json`` in the current directory), each suite to
its own sections.  ``--device`` defaults to ``cuda``; there is no
fallback to the CPU.  Exits non-zero when a suite fails.
"""

from __future__ import annotations

import argparse
import sys

import torch

from . import codec_suite, headline, kernel_suite, matrix


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m minnow_c_tpu_torch.bench")
    p.add_argument("suite", choices=("headline", "kernels", "codecs",
                                     "matrix"))
    p.add_argument("names", nargs="*")
    p.add_argument("--records", default="bench_torch.json")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("minnow_c_tpu_torch.bench: no CUDA device is visible (pass "
              "--device cpu to run on the CPU)", file=sys.stderr)
        if a.suite == "headline":
            headline.main("cuda", a.records)  # the failure line
        return 2
    if a.suite == "headline":
        return headline.main(a.device, a.records)
    if a.suite == "kernels":
        kernel_suite.run(a.device, a.names, a.records)
        return 0
    if a.suite == "codecs":
        names = a.names or [c[0] for c in codec_suite.ALGOS] + [
            "device_decode"]
        codecs = [c for c in names if c != "device_decode"]
        if codecs:
            codec_suite.main(a.device, codecs, a.records)
        if "device_decode" in names:
            codec_suite.device_decode_rates(a.device, a.records)
        return 0
    return matrix.main(a.device, a.names, a.records)


if __name__ == "__main__":
    sys.exit(main())
