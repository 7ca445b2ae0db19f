"""Test v1.0 -- second frozen version of the Test algorithm.

Port of ``minnow_c_tpu/algos/algo_test_v1_0.py``.  Exists to prove the
registry's multi-version contract: v1.0 packs planes (Trim behavior) while
v0.9 streams remain decodable by their own frozen module.
``registry.newest(TEST)`` resolves here.

This module is FROZEN at v1.0.
"""

from __future__ import annotations

from .. import semver
from ..types import AlgoCode
from . import registry
from .algo_trim_v1_0 import TrimV1_0

VERSION = semver.pack(1, 0, 0)


class TestV1_0(TrimV1_0):
    algo_code = int(AlgoCode.TEST)
    version = VERSION


registry.register(TestV1_0())
