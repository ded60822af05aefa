"""Dataclass-as-pytree registration.

Plan objects carry big precomputed arrays (gather indices, weight
pyramids).  They flow into jit as *arguments* (device-resident
buffers), never as embedded constants, so hundreds of MB of tables are
uploaded once instead of being baked into every compiled program.
Registering plans as pytrees lets ``jax.device_put(plan)`` move every
leaf once and jit cache on the static fields.
"""

import dataclasses

import jax

__all__ = ["register_plan"]


def register_plan(cls, children: tuple, static: tuple):
    """Register dataclass ``cls`` as a pytree with ``children`` as traced
    leaves and ``static`` fields as (hashable) aux data."""

    def flatten(obj):
        return (
            tuple(getattr(obj, f) for f in children),
            tuple(_hashable(getattr(obj, f)) for f in static),
        )

    def unflatten(aux, kids):
        kwargs = dict(zip(children, kids))
        kwargs.update(dict(zip(static, aux)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


def _hashable(v):
    if isinstance(v, list):
        return tuple(_hashable(x) for x in v)
    return v
