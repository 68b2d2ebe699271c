"""The check that nothing a run loaded is JAX or the JAX package.

Modules are compared by their top-level name (the part before the first
dot) as a whole: `consent_tpu_torch` is the program, `consent_tpu` the
JAX package it was ported from."""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "consent_tpu")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The loaded module names whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
