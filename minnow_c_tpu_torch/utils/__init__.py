"""Cross-cutting utilities: the MINNOW_DEBUG assert tier (utils.debug) and
input byte-order normalization (native_order)."""

import numpy as np


def native_order(a):
    """Return ``a`` with native byte order (no copy when already native).

    The wire is always little-endian via explicit ``<`` struct/numpy codes
    (stream.py); *inputs*, however, may arrive as byteswapped views (e.g.
    big-endian HDF5 datasets), which torch cannot wrap, so every numpy
    ingestion point normalizes through here."""
    if isinstance(a, np.ndarray) and not a.dtype.isnative:
        return a.astype(a.dtype.newbyteorder("="))
    return a
