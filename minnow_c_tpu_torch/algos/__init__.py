"""L3 algorithm registry and frozen codec versions.

Importing this package registers every frozen algorithm version of the
JAX package, in its order (Trim v1.0 and v1.1, Diff v1.0, Coil v1.0 and
v1.1, Octo v1.0 and v1.1, Sort v1.0, v1.1 and v1.2, Cart v1.0, Test v0.9-dev
and v1.0); the registry is this package's own, separate from the JAX
package's.
"""

from . import registry  # noqa: F401
from . import algo_trim_v1_0  # noqa: F401  (registers Trim v1.0)
from . import algo_trim_v1_1  # noqa: F401  (registers Trim v1.1)
from . import algo_diff_v1_0  # noqa: F401  (registers Diff v1.0)
from . import algo_coil_v1_0  # noqa: F401  (registers Coil v1.0)
from . import algo_coil_v1_1  # noqa: F401  (registers Coil v1.1)
from . import algo_octo_v1_0  # noqa: F401  (registers Octo v1.0)
from . import algo_octo_v1_1  # noqa: F401  (registers Octo v1.1)
from . import algo_sort_v1_0  # noqa: F401  (registers Sort v1.0)
from . import algo_sort_v1_1  # noqa: F401  (registers Sort v1.1)
from . import algo_sort_v1_2  # noqa: F401  (registers Sort v1.2)
from . import algo_cart_v1_0  # noqa: F401  (registers Cart v1.0)
from . import algo_test_v0_9  # noqa: F401  (registers Test v0.9-dev)
from . import algo_test_v1_0  # noqa: F401  (registers Test v1.0)
