"""Frozen dataclass pytrees.

``PyTreeNode`` subclasses become frozen dataclasses registered with
``jax.tree_util.register_dataclass``: their fields are pytree leaves unless
declared with ``field(pytree_node=False)``, which makes them static metadata
(part of the tree structure, hashed into jit cache keys).  ``.replace``
returns a copy with some fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` with a ``pytree_node`` flag (False = static)."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


class PyTreeNode:
    """Base class of the framework's immutable state and model containers."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in fields
                         if f.metadata.get("pytree_node", True)],
            meta_fields=[f.name for f in fields
                         if not f.metadata.get("pytree_node", True)],
        )

    def replace(self, **updates):
        """Copy with the given fields replaced."""
        return dataclasses.replace(self, **updates)
