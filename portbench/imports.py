"""The check that the process that prints a result never loaded JAX or the
JAX package: module names are compared by their top-level name (the part
before the first dot) as a whole, since the port's name begins with the
JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "shadowkv_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """Sorted top-level names of ``modules`` (default ``sys.modules``) that
    are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
