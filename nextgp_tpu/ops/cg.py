"""Device-side conjugate gradient for mixed-model-equation solves.

The reference never solves the MME directly (everything is Gibbs), but the
posterior mean of the ridge/GBLUP conditional is the Henderson MME solution;
this CG gives fast point solutions (BLUP/ridge) and powers the conjugate
statistical tests (SURVEY.md §4.3). Matrix-free: the caller supplies the
matvec, so sharded operators (psum inside the matvec) work unchanged.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..utils import HI


def cg_solve(
    matvec: Callable,
    b,
    x0=None,
    tol: float = 1e-8,
    max_iter: int = 1000,
    precond: Optional[Callable] = None,
):
    """Solve A x = b for SPD A. Returns (x, n_iter, final residual norm)."""
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r) if precond else r
    p = z
    rz = jnp.vdot(r, z, precision=HI)
    bnorm = jnp.linalg.norm(b)

    def cond(carry):
        x, r, p, rz, it = carry
        return (jnp.linalg.norm(r) > tol * jnp.maximum(bnorm, 1e-30)) & (it < max_iter)

    def body(carry):
        x, r, p, rz, it = carry
        ap = matvec(p)
        alpha = rz / jnp.vdot(p, ap, precision=HI)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r) if precond else r
        rz_new = jnp.vdot(r, z, precision=HI)
        p = z + (rz_new / rz) * p
        return x, r, p, rz_new, it + 1

    x, r, p, rz, it = lax.while_loop(cond, body, (x, r, p, rz, jnp.asarray(0)))
    return x, it, jnp.linalg.norm(r)


def mme_matvec(plan, state, var_e, jitter=0.0):
    """Matvec of the full Henderson MME coefficient matrix over the flat
    parameter vector [b; u_1..; beta_1..] for ridge-style (BayesPR) models:

        C = [X'X/ve          X'Z/ve              X'M/ve        ]
            [Z'X/ve   Z'Z/ve + Ainv/vu   ...                   ]
            [M'X/ve          ...        M'M/ve + I/vbeta       ]

    Dense assembly is avoided; each block applies its design matrix.
    Returns (matvec, rhs, sizes) for the current variance values.
    """
    xs = [fs.x for fs in state.fixed]
    zs = [(rs.z, rs.ivstr, rs.var_u) for rs in state.random]
    ms = []
    for msta, mp in zip(state.markers, plan.markers):
        # normalize storage to a flat (p_pad, n) dosage matrix in GLOBAL
        # locus order: de-vshard the (T, V, B, ncol) layout (global block
        # g = v*T + t, so v-major flat) and unpack 2-bit bytes — treating
        # either raw layout as dosages would solve a garbage system.
        # Materializing f32 dosages is fine at the diagnostic scales this
        # solver serves (conjugate tests, BLUP point solutions).
        mt = msta.mt
        center = msta.center
        if mt.ndim == 4:
            V = mt.shape[1]
            mt = jnp.swapaxes(mt, 0, 1).reshape(-1, mt.shape[-1])
            center = jnp.swapaxes(center, 0, 1)
        else:
            mt = mt.reshape(-1, mt.shape[-1])
        center = center.reshape(-1)
        if mp.packed:
            from .pack2 import unpack2

            mt = unpack2(mt, state.ycorr.dtype)[:, : state.ycorr.shape[0]]
        else:
            mt = mt.astype(state.ycorr.dtype)
        vb = msta.var_beta
        ivb = 1.0 / vb[jnp.clip(msta.region_id, 0, mp.n_var - 1)]
        mask = msta.mask.reshape(-1)
        ms.append((mt, center, jnp.where(mask, ivb, 1.0), mask))
    sizes = [x.shape[1] for x in xs] + [z.shape[1] for z, _, _ in zs] + [m[0].shape[0] for m in ms]
    ive = 1.0 / var_e

    def apply_design(vec):
        """eta = X b + Z u + Mc beta for the flat vec."""
        parts = []
        off = 0
        for s in sizes:
            parts.append(lax.dynamic_slice_in_dim(vec, off, s))
            off += s
        eta = jnp.zeros_like(state.ycorr)
        i = 0
        for x in xs:
            eta = eta + jnp.matmul(x, parts[i], precision=HI)
            i += 1
        for z, _, _ in zs:
            eta = eta + jnp.matmul(z, parts[i], precision=HI)
            i += 1
        for mt, c, _, _ in ms:
            beta = parts[i]
            eta = eta + jnp.matmul(beta, mt, precision=HI) - jnp.dot(beta, c, precision=HI)
            i += 1
        return eta, parts

    def matvec(vec):
        eta, parts = apply_design(vec)
        out = []
        i = 0
        for x in xs:
            out.append(jnp.matmul(x.T, eta, precision=HI) * ive)
            i += 1
        for z, ivstr, vu in zs:
            out.append(jnp.matmul(z.T, eta, precision=HI) * ive
                       + jnp.matmul(ivstr, parts[i], precision=HI) / vu)
            i += 1
        for mt, c, ivb, mask in ms:
            beta = parts[i]
            mtv = jnp.matmul(mt, eta, precision=HI) - c * jnp.sum(eta)
            out.append(jnp.where(mask, mtv * ive + ivb * beta + jitter * beta, beta))
            i += 1
        return jnp.concatenate(out)

    y = state.y
    rhs = []
    for x in xs:
        rhs.append(jnp.matmul(x.T, y, precision=HI) * ive)
    for z, _, _ in zs:
        rhs.append(jnp.matmul(z.T, y, precision=HI) * ive)
    for mt, c, _, mask in ms:
        rhs.append(jnp.where(mask, (jnp.matmul(mt, y, precision=HI) - c * jnp.sum(y)) * ive, 0.0))
    return matvec, jnp.concatenate(rhs), sizes


def solve_mme(plan, state, var_e, tol=1e-10, max_iter=2000):
    """Posterior-mode (BLUP/ridge) solution of the current model by CG."""
    matvec, rhs, sizes = mme_matvec(plan, state, var_e)
    x, it, res = cg_solve(matvec, rhs, tol=tol, max_iter=max_iter)
    out = {}
    off = 0
    names = (
        [("b", fp.name) for fp in plan.fixed]
        + [("u", rp.name) for rp in plan.random]
        + [("beta", mp.name) for mp in plan.markers]
    )
    for (kind, name), s in zip(names, sizes):
        out[f"{kind}:{name}"] = x[off : off + s]
        off += s
    return out, int(it), float(res)
