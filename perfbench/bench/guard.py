"""The check that a run loads nothing of JAX or of the JAX package.

Modules are compared by their whole top-level name (the part before the
first dot): ``funscript_flow_tpu_torch`` is the program and passes,
``funscript_flow_tpu`` is the JAX package and does not.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "funscript_flow_tpu"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default:
    ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def check(when: str) -> None:
    """Exit with code 3, naming what was found on standard error, when a
    forbidden module is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"perfbench: {when}: forbidden modules loaded: "
              + ", ".join(found), file=sys.stderr, flush=True)
        raise SystemExit(3)
