"""L5 snapshot layer: a whole snapshot as equal particle blocks, each a
standard Trim v1.0 segment, chained with IOHeaders (``snapshot``)."""

from . import snapshot  # noqa: F401
from .snapshot import (  # noqa: F401
    SnapshotSpec,
    compress_snapshot,
    compress_snapshot_streaming,
    decompress_snapshot,
)
