"""Trim v1.1 -- chunked per-particle-depth packing, frozen.

Port of ``minnow_c_tpu/algos/algo_trim_v1_1.py``.  The wire differs from
Trim v1.0 ONLY in the Deltas-mode (per-particle accuracy) plane payload,
where each 256-element chunk packs uniformly at the chunk's maximum depth;
the uniform-depth path is byte-identical to v1.0.  The port carries the
uniform path; the chunked Deltas payload (``algos/chunked.py`` of the JAX
package) is not ported yet and raises NotImplementedError, as in v1.0.

Streams stamped 1.0.x keep decoding through the frozen v1.0 module.
"""

from __future__ import annotations

from .. import semver
from ..types import AlgoCode
from . import registry
from .algo_trim_v1_0 import TrimV1_0

VERSION = semver.pack(1, 1, 0)


class TrimV1_1(TrimV1_0):
    algo_code = int(AlgoCode.TRIM)
    version = VERSION


registry.register(TrimV1_1())
