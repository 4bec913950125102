"""The check that the process which prints the result never loaded JAX or
the JAX package: whole top-level module names are compared, so the port,
whose name begins with the JAX package's letters, passes."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "pldepth_tpu")


def loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: those
    loaded in this process)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# what keeps libraries that the port uses from loading JAX by themselves
ENV = {"USE_FLAX": "0", "USE_JAX": "0", "USE_TF": "0"}
