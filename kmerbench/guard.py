"""The check that nothing of JAX, nor the JAX package, is loaded.

Names are compared whole by their top-level part, so the port
(kmerset_tpu_torch) passes and the JAX package (kmerset_tpu) does not.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "kmerset_tpu"})


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def require_clean(when: str) -> None:
    """Exits 3, naming what it found on stderr, where a forbidden
    module is loaded."""
    found = forbidden_modules()
    if found:
        print(f"kmerbench: {when}: forbidden modules loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)
