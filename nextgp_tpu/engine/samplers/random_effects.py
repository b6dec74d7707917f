"""Random-effect Gibbs stages (sampleZ!/sampleU, functions.jl:57-110) and
their variance draws (sampleVarU/sampleCoVarU, functions.jl:498-506).

The per-level loop is a Gauss–Seidel scan against the dense inverse
structure (A^-1 / G^-1 / I); the structure row i is the scanned input so the
whole update is one `lax.scan` over levels — sequential like the reference,
but with the rhs dot as one vector product instead of BLAS-1.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ...ops.dists import sample_inv_wishart, sample_scaled_inv_chi2
from ...utils import HI


def sample_random_uni(key, rs, ycorr, var_e, df):
    """Univariate random effect. Returns (u, var_u, ycorr)."""
    q = rs.u.shape[0]
    kz, kv = jax.random.split(key)
    z = jax.random.normal(kz, (q,), rs.u.dtype)
    ive = 1.0 / var_e
    ivu = 1.0 / rs.var_u

    ycorr = ycorr + jnp.matmul(rs.z, rs.u, precision=HI)
    yi = jnp.matmul(rs.zp, ycorr, precision=HI) * ive  # functions.jl:61

    def body(u, xs):
        i, arow, zi = xs
        u = u.at[i].set(0.0)
        rhs = yi[i] - ivu * jnp.dot(arow, u, precision=HI)  # functions.jl:65
        lhs = rs.zpz[i] * ive + arow[i] * ivu  # functions.jl:66
        ui = rhs / lhs + zi * jnp.sqrt(1.0 / lhs)
        return u.at[i].set(ui), None

    u, _ = lax.scan(body, rs.u, (jnp.arange(q), rs.ivstr, z))
    ycorr = ycorr - jnp.matmul(rs.z, u, precision=HI)

    ss = jnp.dot(jnp.matmul(u, rs.ivstr, precision=HI), u, precision=HI)
    var_u = sample_scaled_inv_chi2(kv, df, rs.scale, ss, float(q))  # functions.jl:498-501
    return u, var_u, ycorr


def sample_random_cg(key, rs, ycorr, var_e, df, plan, d_inv=None):
    """Exact joint MvNormal draw of u | rest by perturbed conjugate gradient
    (matrix-free replacement of the per-level scan for large q).

    With C = Z'D^-1 Z / ve + K / vu (K = inverse structure), the draw
        u = C^-1 [ Z'D^-1 (ycorr + e1) / ve + s ],
        e1 ~ N(0, ve D),  s ~ N(0, K / vu)
    has exactly the conditional distribution N(C^-1 Z'D^-1 ycorr / ve, C^-1)
    the reference's scan targets one coordinate at a time. s uses the
    Henderson factorization K = (I-P)' D_f^-1 (I-P) (data/pedigree.py:
    a_inverse_factor), so no Cholesky of K is ever formed.
    """
    from ...ops.cg import cg_solve

    q = rs.u.shape[0]
    n = ycorr.shape[0]
    dtype = ycorr.dtype
    k1, k2, kv = jax.random.split(key, 3)
    idx = jnp.where(rs.z_idx >= 0, rs.z_idx, q)

    def Zt(vec_n):  # Z' v via segment sum
        return jax.ops.segment_sum(vec_n, idx, num_segments=q + 1)[:q]

    def Z(vec_q):  # Z v via gather (padded slot q -> 0)
        return jnp.concatenate([vec_q, jnp.zeros((1,), dtype)])[idx]

    def ivmul(v):  # K v from padded sparse rows
        return jnp.sum(rs.iv_val * v[rs.iv_idx], axis=1)

    def factor_t(x):  # (I - P)' x
        si = jnp.where(rs.fac_sire >= 0, rs.fac_sire, q)
        di = jnp.where(rs.fac_dam >= 0, rs.fac_dam, q)
        half = 0.5 * x
        return (
            x
            - jax.ops.segment_sum(half, si, num_segments=q + 1)[:q]
            - jax.ops.segment_sum(half, di, num_segments=q + 1)[:q]
        )

    ive = 1.0 / var_e
    ivu = 1.0 / rs.var_u
    ycorr = ycorr + Z(rs.u)

    w = (1.0 / d_inv) if d_inv is not None else 1.0
    e1 = jax.random.normal(k1, (n,), dtype) * jnp.sqrt(var_e * w)
    xi = jax.random.normal(k2, (q,), dtype)
    s = factor_t(rs.fac_dsqrt * xi) * jnp.sqrt(ivu)
    yp = ycorr + e1
    rhs = Zt(d_inv * yp if d_inv is not None else yp) * ive + s

    def matvec(v):
        zv = Z(v)
        if d_inv is not None:
            zv = d_inv * zv
        return Zt(zv) * ive + ivmul(v) * ivu

    u, _, _ = cg_solve(matvec, rhs, x0=rs.u, tol=plan.cg_tol, max_iter=plan.cg_iters)
    ycorr = ycorr - Z(u)

    ss = jnp.dot(u, ivmul(u), precision=HI)
    var_u = sample_scaled_inv_chi2(kv, df, rs.scale, ss, float(q))
    return u, var_u, ycorr


def sample_random_corr(key, rs, ycorr, var_e, df):
    """Correlated group (tuple key): per-level MvNormal with Kronecker
    structure (functions.jl:75-110). Returns (u, var_u, ycorr)."""
    n_t, q = rs.u.shape
    kz, kv = jax.random.split(key)
    z = jax.random.normal(kz, (q, n_t), rs.u.dtype)

    # restore all components (functions.jl:101-104)
    ycorr = ycorr + jnp.einsum("tnl,tl->n", rs.zs, rs.u, precision=HI)
    yi = jnp.einsum("tnl,n->tl", rs.zs, ycorr, precision=HI)  # per-level Z_l' ycorr
    ivu = jnp.linalg.inv(rs.var_u)

    def body(u, xs):
        i, arow, zpz_i, zi = xs
        u = u.at[:, i].set(0.0)
        # kron(ivstr[i,:], iVarU) @ vec(u) == iVarU @ (u @ ivstr[i,:]) (functions.jl:82)
        rhs = yi[:, i] / var_e - ivu @ (u @ arow)
        lhs = zpz_i / var_e + arow[i] * ivu  # functions.jl:83
        cov = jnp.linalg.inv(lhs)
        cov = (cov + cov.T) / 2.0
        mean = cov @ rhs
        ui = mean + jnp.linalg.cholesky(cov) @ zi
        return u.at[:, i].set(ui), None

    u, _ = lax.scan(body, rs.u, (jnp.arange(q), rs.ivstr, rs.zpz, z))

    # covariance draw BEFORE removing effects, as in functions.jl:105-106
    s = u @ rs.ivstr @ u.T + rs.scale
    var_u = sample_inv_wishart(kv, df + q, (s + s.T) / 2.0)

    ycorr = ycorr - jnp.einsum("tnl,tl->n", rs.zs, u, precision=HI)
    return u, var_u, ycorr
