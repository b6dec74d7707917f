"""Small shared utilities for nextgp_tpu.

Pytree dataclass registration, rounding helpers, and dtype plumbing used
across the engine. No reference-code counterpart (infrastructure only).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

# Full float32 products. A GPU may run a default-precision f32 dot in TF32
# (about three decimal digits); the blocked-Gram identity and the
# incrementally updated residual need every product on the chain's path to
# agree in f32, so those dots pass precision=HI.
HI = jax.lax.Precision.HIGHEST


def pytree_dataclass(cls=None, *, meta: tuple[str, ...] = ()):
    """Register a frozen dataclass as a JAX pytree.

    Fields named in ``meta`` are static (hashable aux data baked into the
    jaxpr); all others are traced leaves.
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        fields = [f.name for f in dataclasses.fields(c)]
        data_fields = [f for f in fields if f not in meta]
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=list(meta)
        )
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def replace(obj, **kwargs):
    """dataclasses.replace that works on our frozen pytree dataclasses."""
    return dataclasses.replace(obj, **kwargs)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def default_real_dtype():
    """f64 when jax_enable_x64 is on (golden/CPU tests), else f32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def asarray(x: Any, dtype=None):
    return jnp.asarray(x, dtype=dtype or default_real_dtype())
