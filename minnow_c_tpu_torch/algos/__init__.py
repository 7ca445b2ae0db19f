"""L3 algorithm registry and frozen codec versions.

Importing this package registers every ported frozen algorithm version
(Trim v1.0 and v1.1 so far); the registry is this package's own, separate
from the JAX package's.
"""

from . import registry  # noqa: F401
from . import algo_trim_v1_0  # noqa: F401  (registers Trim v1.0)
from . import algo_trim_v1_1  # noqa: F401  (registers Trim v1.1)
