"""Test v0.9-dev -- the frozen-version pattern demonstrator.

Port of ``minnow_c_tpu/algos/algo_test_v0_9.py``; the wire is the same byte
for byte.  Mirror of the reference's ``algo_Test_v0_9.{h,c}`` (an
intentionally trivial algorithm whose job is to exercise the versioning
machinery, header_format.tex:278-283).  Test v0.9 stores bins *unpacked*
-- each bin index as a full little-endian u32 word, entropy-coded --
deliberately naive so the wire differs from every real codec, making
version-dispatch mistakes loud in tests.

Together with ``algo_test_v1_0`` it demonstrates two frozen major.minor
versions of one algorithm coexisting in the registry: streams stamped
0.9.x decode with this module forever, regardless of what v1.0 does.

This module is FROZEN at v0.9.
"""

from __future__ import annotations

import numpy as np

from .. import semver
from ..types import AlgoCode
from . import registry
from .algo_trim_v1_0 import TrimV1_0, _words_tensor

VERSION = semver.pack(0, 9, 0, semver.DEV)


class TestV0_9(TrimV1_0):
    algo_code = int(AlgoCode.TEST)
    version = VERSION

    def _encode_plane(self, bins, depth: int):
        # naive: full words, no packing (width marker 32)
        return bins.cpu().numpy().view(np.uint32), 32

    def _decode_plane(self, words: np.ndarray, width: int, n: int, device):
        return _words_tensor(words[:n], device)


registry.register(TestV0_9())
