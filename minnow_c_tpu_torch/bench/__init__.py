"""The port's measuring layer: the JAX package's benchmark harness and
records (``minnow_c_tpu/bench``) and its benchmark scripts (``bench.py``,
``bench_kernels.py``, ``bench_codecs.py``, ``bench_all.py``) on the card.

    python -m minnow_c_tpu_torch.bench {headline,kernels,codecs,matrix}

Modules: ``harness`` (the adaptive trial policy, CUDA-event timed),
``records`` (merge-safe records files, a byte-identical copy of the JAX
package's), ``counts`` (the kernels' launch counters), ``headline``,
``kernel_suite``, ``codec_suite`` and ``matrix`` (the suites).  Every
suite runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from . import harness  # noqa: F401
from .harness import Result, run  # noqa: F401
