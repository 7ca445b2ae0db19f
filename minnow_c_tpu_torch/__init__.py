"""minnow_c_tpu_torch: the PyTorch / CUDA port of minnow_c_tpu, error-bounded
lossy compression of cosmological N-body particle snapshots.

The JAX package ``minnow_c_tpu`` stays the reference; this package writes
and reads the same bytes.  It imports torch and never jax (nor the JAX
package).  Array stages are torch ops on the device of the data; the
kernels that the JAX package wrote in Pallas for the TPU are CUDA C++ for
Hopper (``csrc/``), each beside a plain torch version that CPU tensors use.

Layer map (mirrors the JAX package):
  L1  ops/        -- torch array ops, the CUDA kernels' wrappers
                     (decode_cuda, encode_cuda, scan_cuda, chunked_cuda),
                     native entropy/checksum, RNG
  L2  quant/      -- per-field-type quantization engine (the lossy stage)
  L3  algos/      -- versioned algorithm registry + frozen codec modules
  L4  segment/    -- segment API, wire format, stream reader/writer, file I/O
  L5  parallel/   -- snapshots: block-batched encode/decode of whole
                     snapshots into chained segment files; the
                     block-sharded codecs over a mesh of shards; the
                     multi-process (gloo) writer and reader
  L6  drivers/    -- the Gadget-2 driver; ``python -m minnow_c_tpu_torch``
                     is the CLI (__main__.py)

Ported so far: the Trim codec (v1.0, v1.1), the delta codecs Diff v1.0,
Coil v1.0 / v1.1 and Octo v1.0 / v1.1, Sort v1.0 / v1.1 / v1.2 and Cart
v1.0, for all five field types, with Deltas mode and the log maps; the
single-host snapshot writer and reader (compress_snapshot /
decompress_snapshot) and the streaming writer
(compress_snapshot_streaming), in the div and recip scale modes; the
block-sharded codecs and the multihost writer and reader; the Gadget-2
and Illustris drivers and the CLI.  See ROADMAP.md for the rest.
"""

from . import semver, types  # noqa: F401
from . import algos, parallel, quant, segment  # noqa: F401
from .parallel.snapshot import (  # noqa: F401
    SnapshotSpec,
    compress_snapshot,
    compress_snapshot_streaming,
    decompress_snapshot,
)
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
