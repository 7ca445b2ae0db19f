"""Carry segments across from the JAX package.

``seg_from_reference`` turns a ``minnow_c_tpu`` ``Seg`` into this package's
``Seg``.  It reads the reference objects by attribute name only, so it
never imports jax or the JAX package: field data become numpy arrays and
accuracy requests become this package's dataclass of the same name.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import types


def _accuracy(acc):
    if acc is None:
        return None
    cls = getattr(types, type(acc).__name__)
    return cls(**{f.name: getattr(acc, f.name)
                  for f in dataclasses.fields(cls)})


def seg_from_reference(seg) -> types.Seg:
    """A ``minnow_c_tpu`` Seg (numpy or jax arrays) -> this package's Seg
    with numpy data, ready for ``compress_segment``."""
    fields = []
    for f in seg.fields:
        hd = types.FieldHeader(field_code=int(f.hd.field_code),
                               algo_code=int(f.hd.algo_code),
                               algo_version=int(f.hd.algo_version),
                               particle_len=int(f.hd.particle_len))
        data = None if f.data is None else np.asarray(f.data)
        fields.append(types.Field(hd=hd, data=data, acc=_accuracy(f.acc),
                                  valid=f.valid))
    return types.Seg(fields=fields)
