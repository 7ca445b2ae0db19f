"""L4 segment API, wire format and stream layer."""

from . import api, format, stream  # noqa: F401
from .api import (  # noqa: F401
    compress,
    compress_segment,
    decompress,
    decompress_segment,
    quantize,
    undo_quantize,
)
