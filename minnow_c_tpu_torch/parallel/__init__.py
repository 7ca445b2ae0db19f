"""L5 snapshot layer: a whole snapshot as equal particle blocks, each a
standard Trim v1.0 segment, chained with IOHeaders (``snapshot``); the
block-sharded codecs over a mesh of shards (``sharding``); the
multi-process setup and collectives (``multihost``) behind the
distributed writer and reader."""

from . import multihost, sharding, snapshot  # noqa: F401
from .sharding import (  # noqa: F401
    Mesh,
    ShardedPositionCodec,
    ShardedSnapshotCodec,
    adaptive_depth_for,
    block_split,
    make_mesh,
    spmd_depth_for,
)
from .snapshot import (  # noqa: F401
    SnapshotSpec,
    compress_snapshot,
    compress_snapshot_multihost,
    compress_snapshot_streaming,
    decompress_snapshot,
    decompress_snapshot_multihost,
)
