"""Frozen dataclass containers for the torch port.

The engine's ``Model`` / ``Data`` containers are frozen dataclasses whose
array fields are ``torch.Tensor`` leaves.  Fields marked ``static()`` carry
host-side metadata (counts, paddings, integrator choice, index layouts) that
``engine.put_model`` leaves untouched; everything else is a tensor leaf (or
numpy before ``put_model``).  "Mutation" is functional replacement through
``.replace()``, as in the JAX package (mujoco_sim_tpu/utils/struct.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, TypeVar

T = TypeVar("T")

_STATIC_KEY = "__mst_static__"


def static(**kwargs) -> dataclasses.Field:
    """Declare a dataclass field as static (host metadata, not a tensor)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata[_STATIC_KEY] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def field(**kwargs) -> dataclasses.Field:
    """Declare a regular (tensor leaf) dataclass field."""
    return dataclasses.field(**kwargs)


def leaf_names(obj) -> Iterator[str]:
    """Names of the non-static fields of a container instance or class."""
    for f in dataclasses.fields(obj):
        if not f.metadata.get(_STATIC_KEY, False):
            yield f.name


def frozen(cls: type[T]) -> type[T]:
    """Class decorator: frozen dataclass with ``.replace(**updates)``."""
    cls = dataclasses.dataclass(frozen=True, eq=False)(cls)

    def replace(self: T, **updates: Any) -> T:
        return dataclasses.replace(self, **updates)

    cls.replace = replace  # type: ignore[attr-defined]
    return cls


def map_leaves(fn, obj):
    """Apply fn to every tensor leaf, recursing into nested containers."""
    updates = {}
    for name in leaf_names(obj):
        v = getattr(obj, name)
        updates[name] = (map_leaves(fn, v) if dataclasses.is_dataclass(v)
                         else fn(v))
    return dataclasses.replace(obj, **updates)
