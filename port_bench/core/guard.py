"""The check that a run loaded neither JAX nor the JAX package.

Modules are compared by their whole top-level name (the part before the
first dot): the port's package, ``svit_tpu_torch``, begins with the JAX
package's name, ``svit_tpu``, and is not it.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "svit_tpu"})


def forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default:
    ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & FORBIDDEN)
