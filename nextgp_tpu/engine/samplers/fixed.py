"""Fixed-effect Gibbs stages (sampleX!/sampleb!, functions.jl:22-53).

Single-column blocks use the summary-stat offsets; multi-column blocks run
the "Wang's trick" Gauss–Seidel scan over coefficients (which, as in the
reference, does NOT apply summary-stat offsets — functions.jl:29-30).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ...utils import HI


def sample_fixed_block(key, fs, ycorr, var_e, single: bool):
    """Returns (new_b, new_ycorr)."""
    ive = 1.0 / var_e
    k = fs.b.shape[0]
    z = jax.random.normal(key, (k,), fs.b.dtype)
    if single:
        x = fs.x[:, 0]
        ycorr = ycorr + x * fs.b[0]
        rhs = jnp.dot(fs.xp[0], ycorr, precision=HI) * ive + fs.rhs_ss[0]
        lhs = fs.xpx[0, 0] * ive + fs.lhs_ss[0]
        bnew = rhs / lhs + z[0] * jnp.sqrt(1.0 / lhs)
        ycorr = ycorr - x * bnew
        return fs.b.at[0].set(bnew), ycorr

    ycorr = ycorr + jnp.matmul(fs.x, fs.b, precision=HI)
    yi = jnp.matmul(fs.xp, ycorr, precision=HI) * ive  # X'ycorr/varE for all coefficients (functions.jl:25)

    def body(bvec, xs):
        i, zrow, zi = xs
        bvec = bvec.at[i].set(0.0)
        rhsb = yi[i] - jnp.dot(zrow, bvec, precision=HI) * ive
        lhsb = zrow[i] * ive
        bi = rhsb / lhsb + zi * jnp.sqrt(1.0 / lhsb)
        return bvec.at[i].set(bi), None

    bnew, _ = lax.scan(body, fs.b, (jnp.arange(k), fs.xpx, z))
    ycorr = ycorr - jnp.matmul(fs.x, bnew, precision=HI)
    return bnew, ycorr
