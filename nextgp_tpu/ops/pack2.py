"""2-bit planar genotype packing and the two panel passes over packed rows.

Dosages are {0,1,2}: int8 storage spends 4x the memory traffic the sweep
is bound by (the gather `Mc @ ycorr` and the scatter `ycorr += u @ Mc` read
the whole panel every sweep). Packing four dosages per byte cuts the
genotype bytes 4x; the unpack is a few integer ops per value, fused into
the pass that reads the byte.

Planar layout: with q packed lanes, byte j of a locus row holds
individuals j, j+q, j+2q, j+3q in its four 2-bit fields:

    packed[:, j] = g[j] | g[j+q] << 2 | g[j+2q] << 4 | g[j+3q] << 6

so unpacking is  concat([pk & 3, (pk>>2) & 3, (pk>>4) & 3, (pk>>6) & 3])
along the lane axis — four contiguous slices in original individual order,
and the residual vector is viewed as (4, q) by a plain reshape.

The individual axis is padded to n4 = 4*q with q a multiple of 128 (part
of the `from_packed` storage format); padded genotypes are 0, so they
never contribute to a pass.

Reference equivalence: packing is lossless for 0..3 dosages, so the exact
unpack path (`unpack2` followed by the same product as int8 storage) is
bit-identical to unpacked storage. The reference stores dense f64
(prepMatVec.jl:129) — 32x the bytes per pass.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

F32 = jnp.float32
_LANES = 128


def packed_q(n: int) -> int:
    """Packed lane count for n individuals: ceil(n/4) rounded to 128 lanes."""
    q = -(-n // 4)
    return -(-q // _LANES) * _LANES


def pack2_np(g: np.ndarray) -> np.ndarray:
    """(n, p) int {0..3} -> (p, q) uint8 planar-packed, q = packed_q(n)."""
    n, p = g.shape
    q = packed_q(n)
    gp = np.zeros((4 * q, p), np.uint8)
    gp[:n] = g
    g4 = gp.reshape(4, q, p)
    pk = g4[0] | (g4[1] << 2) | (g4[2] << 4) | (g4[3] << 6)
    return np.ascontiguousarray(pk.T)


def pack2_jnp(g):
    """Device-side pack: (n, p) int8 -> (p, q) uint8 (one fused jit)."""
    n, p = g.shape
    q = packed_q(n)

    @jax.jit
    def _pack(gg):
        gp = jnp.zeros((4 * q, p), jnp.uint8).at[:n].set(gg.astype(jnp.uint8))
        g4 = gp.reshape(4, q, p)
        pk = g4[0] | (g4[1] << 2) | (g4[2] << 4) | (g4[3] << 6)
        return pk.T

    return _pack(g)


def unpack2(pk, dtype=F32):
    """Exact inverse of the planar pack: (..., R, q) uint8 -> (..., R, 4q)."""
    pki = pk.astype(jnp.int32)
    parts = [(pki >> (2 * k)) & 3 for k in range(4)]
    return jnp.concatenate(parts, axis=-1).astype(dtype)


def _planes(pk, dtype):
    """(R, q) uint8 -> (R, 4, q) dosages, plane k = bits 2k..2k+1. Meant to
    be fused by XLA into the reduction that consumes it."""
    shifts = (2 * jnp.arange(4, dtype=jnp.uint8))[:, None]
    return ((pk[:, None, :] >> shifts) & 3).astype(dtype)


def gather(pk, y):
    """r = unpack(pk)[:, :n] @ y as one multiply-and-reduce over the planar
    view: pk (R, q) uint8, y (n,) with n <= 4q. Returns (R,) in y's dtype.

    Elementwise products summed in y's dtype (no matrix unit, so no
    reduced-precision product); XLA fuses the unpack into the reduction,
    which reads each packed byte once."""
    q = pk.shape[-1]
    y4 = jnp.pad(y, (0, 4 * q - y.shape[0])).reshape(4, q)
    return jnp.sum(_planes(pk, y.dtype) * y4, axis=(1, 2))


def scatter(pk, u, n):
    """d = u @ unpack(pk)[:, :n] as one column reduction over the rows:
    pk (R, q) uint8, u (R,). Returns (n,) in u's dtype."""
    d4 = jnp.sum(_planes(pk, u.dtype) * u[:, None, None], axis=0)
    return d4.reshape(-1)[:n]
