"""L5 client drivers: standardized snapshot-format converters
(header_format.tex:37-42).  The Illustris driver imports h5py inside its
functions, so it imports without h5py."""

from . import gadget2  # noqa: F401
from . import illustris  # noqa: F401
