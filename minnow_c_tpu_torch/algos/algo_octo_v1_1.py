"""Octo v1.1 -- Morton hierarchical codec on the v1.1 chunked layout,
frozen.

Port of ``minnow_c_tpu/algos/algo_octo_v1_1.py``; the wire is the same byte
for byte.  Over Octo v1.0 the Morton cell stream -- the codec's dominant
plane -- uses the Coil v1.1 plane format (parametric chunk size +
column-major chunk bodies), so from 2^20 particles on it decodes through
K10 (``ops/chunked_cuda.py``).  The within-cell offset planes and the block
layout (``meta | morton | loX | loY | loZ``) are unchanged.

Streams stamped 1.0.x keep decoding through the frozen algo_octo_v1_0
module.  This module is FROZEN at v1.1.
"""

from __future__ import annotations

from .. import semver
from ..types import AlgoCode
from . import registry
from .algo_coil_v1_1 import CoilV1_1
from .algo_octo_v1_0 import OctoV1_0

VERSION = semver.pack(1, 1, 0)


class OctoV1_1(OctoV1_0):
    algo_code = int(AlgoCode.OCTO)
    version = VERSION

    # The MRO is OctoV1_1 -> OctoV1_0 -> CoilV1_0 -> TrimV1_0, and CoilV1_1
    # derives from TrimV1_0 directly, so its plane codec is reached by
    # explicit unbound calls.

    def _encode_plane(self, bins, depth: int):
        return CoilV1_1._encode_plane(self, bins, depth)

    def _decode_plane(self, words, width: int, n: int, device):
        return CoilV1_1._decode_plane(self, words, width, n, device)


registry.register(OctoV1_1())
