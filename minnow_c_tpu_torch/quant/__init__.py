"""L2: the quantization engine (the lossy stage)."""

from . import engine  # noqa: F401
from .engine import dequantize, quantize  # noqa: F401
