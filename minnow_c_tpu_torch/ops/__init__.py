"""L1 ops: torch kernels, the CUDA kernels' wrappers, native entropy and
checksum, RNG."""

from . import bitpack, checksum, entropy, kernels, native, rng  # noqa: F401
