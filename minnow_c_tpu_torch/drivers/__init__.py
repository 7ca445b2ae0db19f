"""L5 client drivers: standardized snapshot-format converters
(header_format.tex:37-42).  Gadget-2 is ported; the Illustris HDF5 driver
(it needs h5py) is not yet."""

from . import gadget2  # noqa: F401
