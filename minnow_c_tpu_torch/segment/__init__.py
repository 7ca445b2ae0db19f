"""L4 segment API, wire format, stream layer, and file I/O."""

from . import api, format, io, stream  # noqa: F401
from .api import (  # noqa: F401
    compress,
    compress_segment,
    decompress,
    decompress_segment,
    from_bytes,
    quantize,
    to_bytes,
    undo_quantize,
)
