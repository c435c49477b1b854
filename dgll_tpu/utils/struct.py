"""Frozen dataclasses that are JAX pytrees.

``@dataclass`` makes a frozen dataclass whose fields are pytree children, except
those declared with ``field(pytree_node=False)``: those are static metadata kept
in the tree definition (hashed by ``jit``, never traced). ``.replace(**changes)``
returns a copy with some fields changed.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def dataclass(cls):
    """Frozen dataclass registered as a pytree (see module docstring)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields if not f.metadata.get("pytree_node", True)],
    )
    cls.replace = dataclasses.replace
    return cls
