"""minnow_c_tpu_torch: the PyTorch / CUDA port of minnow_c_tpu, error-bounded
lossy compression of cosmological N-body particle snapshots.

The JAX package ``minnow_c_tpu`` stays the reference; this package writes
and reads the same bytes.  It imports torch and never jax (nor the JAX
package).  Array stages are torch ops on the device of the data; the
kernels that the JAX package wrote in Pallas for the TPU are CUDA C++ for
Hopper (``csrc/``), each beside a plain torch version that CPU tensors use.

Layer map (mirrors the JAX package):
  L1  ops/        -- torch array ops, the CUDA kernels' wrappers
                     (decode_cuda, encode_cuda), native entropy/checksum, RNG
  L2  quant/      -- per-field-type quantization engine (the lossy stage)
  L3  algos/      -- versioned algorithm registry + frozen codec modules
  L4  segment/    -- segment API, wire format, stream reader/writer

Ported so far: the Trim codec (v1.0, v1.1) at uniform depth with the linear
map, for all five field types.  See ROADMAP.md for the rest.
"""

from . import semver, types  # noqa: F401
from . import algos, quant, segment  # noqa: F401
from .segment.api import (  # noqa: F401
    compress_segment,
    decompress_segment,
    transcode_segment,
)
from .types import (  # noqa: F401
    AlgoCode,
    CField,
    CSeg,
    Field,
    FieldCode,
    FieldHeader,
    FloatAccuracy,
    IDAccuracy,
    IntAccuracy,
    PositionAccuracy,
    QField,
    QSeg,
    Seg,
    VelocityAccuracy,
)

__version__ = "0.1.0"
