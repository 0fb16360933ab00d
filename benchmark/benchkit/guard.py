"""The run's guard against the JAX package: no module of the process may
have a forbidden top-level name (the part of the module's name before its
first dot, compared whole, so ``recsys_tpu_torch`` passes)."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "recsys_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The sorted top-level names of ``modules`` (default ``sys.modules``)
    that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__(f"modules loaded that the benchmark may not load: {names}")
        self.names = names


def check() -> None:
    """Raise ``ForbiddenModules`` if the process holds a forbidden module."""
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
