"""Blocked single-site Gibbs for marker effects — all Bayesian-alphabet
methods (sampleBayesPR!/B!/C!/R!/RCpi!/RCplus!/LV!, functions.jl:118-486).

The re-architecture (SURVEY.md §7.4, hard part #1): the reference's per-locus
loop touches the n-vector ycorr three times per locus (axpy-in, dot,
axpy-out — functions.jl:128-133), which is sequential BLAS-1. Here each
block of B loci interacts with ycorr only twice per block, through two
passes over the block's panel rows:

    r0 = Mc_blk @ ycorr                    # before the block
    ycorr += u @ Mc_blk                    # after the block

while the exact per-locus chain dependency is preserved through the block's
centered Gram matrix G = Mc_blk Mc_blk'. Maintaining u = beta_old - beta_cur
(zero for unprocessed loci), the residual dot the reference computes *after
restoring locus j* equals

    m_j' ycorr_current = r0[j] + G[j, :] @ u     with u[j] set to beta_old[j]

so the in-block scan reproduces the reference's sequential update order
bit-for-bit in exact arithmetic. Weighted residuals ("D") carry a second,
unweighted Gram for BayesB/C's raw indicator dot (functions.jl:168,208 use
the plain dot even when rhs is weighted).

Sharding (ShardCtx): every function also runs under shard_map with its
marker arrays holding only the local block shard. The residual is
replicated; the per-block correction and every cross-locus reduction
(region sums, inclusion counts, class counts, LV moments) go through
ctx.psum. Per-locus random streams are generated at GLOBAL length from the
chain key and sliced per shard, so the same chain is sampled regardless of
the shard count (BayesRCpi's Dirichlet gammas included: their annotation
inputs are replicated, so they too are drawn at global length).

All randomness is pre-generated per sweep from counter-based keys
(engine/rng.py) and consumed positionally, so the pure-JAX path, the Triton
kernel path and the NumPy golden oracle share identical streams.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ...ops import gibbs_kernels
from ...ops.dists import categorical_from_probs, sample_beta_dist, sample_dirichlet
from ...utils import HI, replace
from ..sharding import UNSHARDED, ShardCtx
from ..plan import (
    METHOD_B,
    METHOD_C,
    METHOD_LV,
    METHOD_PR,
    METHOD_R,
    METHOD_RCPI,
    METHOD_RCPLUS,
    MarkerPlan,
)


# ------------------------------------------------------------------ helpers


def _chi2(key, half_df_times2):
    return 2.0 * jax.random.gamma(key, jnp.asarray(half_df_times2) / 2.0)


def _local_dims(ms, mp):
    nb_l = ms.mpm.shape[0]
    return nb_l, nb_l * mp.block


def _rnorm(key, mp, ctx, p_local, dtype, extra=()):
    full = jax.random.normal(key, (mp.p_pad,) + tuple(extra), dtype)
    return ctx.slice_p(full, p_local)


def _runif(key, mp, ctx, p_local, dtype, extra=()):
    full = jax.random.uniform(key, (mp.p_pad,) + tuple(extra), dtype)
    return ctx.slice_p(full, p_local)


def _blockify_dev(a, nb, B):
    return a.reshape((nb, B) + a.shape[1:])


# ------------------------------------------------------------------ core scan


def _block_scan(gram_b, gram_raw_b, r0, r0_raw, beta_old_b, locus_xs, locus_fn, dtype):
    """Sequential in-block scan. locus_fn(pre, pre_raw, bold, lx) -> (bnew, out)."""
    B = r0.shape[0]
    have_raw = gram_raw_b is not None

    xs = (jnp.arange(B), gram_b,
          gram_raw_b if have_raw else jnp.zeros((B, 0), dtype),
          r0, r0_raw if have_raw else jnp.zeros((B,), dtype),
          beta_old_b, locus_xs)

    def body(u, xsj):
        j, grow, graw, r0j, r0rj, bold, lx = xsj
        u = u.at[j].set(bold)
        pre = r0j + jnp.dot(grow, u, precision=HI)
        pre_raw = (r0rj + jnp.dot(graw, u, precision=HI)) if have_raw else pre
        bnew, out = locus_fn(pre, pre_raw, bold, lx)
        u = u.at[j].set(bold - bnew)
        return u, (bnew, out)

    u0 = jnp.zeros((B,), dtype)
    u, (beta_new, outs) = lax.scan(body, u0, xs)
    return u, beta_new, outs


def _gram_raw_diag(ms):
    """Raw per-locus m'm (diag of gram_raw) in global flat locus order —
    the weighted BC kernels' rrr restore adjustment (functions.jl:168)."""
    g = ms.gram_raw
    if g.ndim == 3:  # (nb, B, B)
        return jnp.diagonal(g, axis1=1, axis2=2).reshape(-1)
    d = jnp.diagonal(g, axis1=1, axis2=3)  # (T, B, V, B) -> (T, V, B)
    return jnp.swapaxes(d, 0, 1).reshape(-1)  # global block g = v*T + t


def _panel_passes(packed, n_real, dtype, fused):
    """(gather, scatter) over one step's (rows, ncol) panel slice:
    gather(mtb, y) = M_blk @ y (rows,), scatter(mtb, u) = u @ M_blk (n,).

    fused (the GPU form): one multiply-and-reduce per pass that reads the
    int8 or packed bytes once (ops/pack2.gather/scatter). Otherwise a dot
    over the unpacked block: packed and int8 storage then run the same
    product on the same values, so their chains are bit-identical (what
    the CPU tests pin)."""
    from ...ops import pack2

    if fused:
        if packed:
            return pack2.gather, lambda mtb, u: pack2.scatter(mtb, u, n_real)
        return (lambda mtb, y: jnp.sum(mtb.astype(dtype) * y, axis=-1),
                lambda mtb, u: jnp.sum(mtb.astype(dtype) * u[:, None], axis=0))

    def dense(mtb):
        return pack2.unpack2(mtb, dtype)[:, :n_real] if packed else mtb.astype(dtype)

    return (lambda mtb, y: jnp.matmul(dense(mtb), y, precision=HI),
            lambda mtb, u: jnp.matmul(u, dense(mtb), precision=HI))


def _blocked_sweep(ms, ycorr, d_inv, locus_fn, locus_xs, dtype, need_raw, ctx,
                   fused=False, kernel=None, coefs=()):
    """Outer scan over (local) marker blocks; carries the replicated ycorr.

    Virtual shards: with V block chains per step (storage mt (T, V, B, n)),
    shard v owns the contiguous blocks [v*T, (v+1)*T), T = nb/V, and the
    residual synchronizes at block-step boundaries — the one-device analog
    of the multi-device schedule in parallel/sharded.py. The per-draw chain
    matches a V-device run, not the V=1 sequential order. Outputs are
    re-ordered back to the global flat locus order before returning.

    kernel (the Triton route): kernel(gram, graw, t, r0, r0_raw, *coefs) ->
    (u, beta_new, outs), all (V, B, ...), with the Gram streams locus-major
    (T, B, V, B) and each coefficient array (T, V, B, ...) indexed by the
    block step t inside the kernel; coefs arrive here in flat locus order.
    Plain V=1 storage runs through the same frame as V=1. Without a kernel
    the in-block scan is the plain `_block_scan` around locus_fn.
    """
    use_raw = need_raw and d_inv is not None
    graw = ms.gram_raw if ms.gram_raw is not None else ms.gram
    nb, B = ms.mpm.shape
    # V is derived from the STORAGE layout, not the plan: mt is (nb, B, n)
    # in plain layout and (T, V, B, n) in vshard layout. Under shard_map the
    # vshard axis is split across devices, so the local V here is the
    # per-device share V_total / n_shards (possibly 1) while mp.vshards
    # stays global — the storage shape is the single source of truth.
    V = ms.mt.shape[1] if ms.mt.ndim == 4 else 1
    T = nb // V
    n_real = ycorr.shape[0]
    gather, scatter = _panel_passes(ms.mt.dtype == jnp.uint8, n_real, dtype, fused)

    def project(mtb, cb, ycorr):  # r0 (and raw r0) of one step's rows
        if d_inv is not None:
            yw = d_inv * ycorr
            r0 = gather(mtb, yw) - cb * jnp.sum(yw)
            r0_raw = (gather(mtb, ycorr) - cb * jnp.sum(ycorr)) if use_raw else None
        else:
            r0 = gather(mtb, ycorr) - cb * jnp.sum(ycorr)
            r0_raw = None
        return r0, r0_raw

    def group(a):  # flat (nb*B, ...) or (nb, B, ...) -> (T, V, B, ...), g = v*T + t
        a = a.reshape((V, T, B) + a.shape[1 if a.shape[0] == nb * B else 2:])
        return jnp.swapaxes(a, 0, 1)

    def ungroup(a):  # (T, V, B, ...) -> global flat (nb*B, ...)
        return jnp.swapaxes(a, 0, 1).reshape((nb * B,) + a.shape[3:])

    if kernel is not None:
        mt4 = ms.mt if ms.mt.ndim == 4 else ms.mt[:, None]
        cen = ms.center.reshape(T, V, B)

        def locus_major(g):  # (nb, B, B) plain layout is (T, B, 1, B)
            return g if g.ndim == 4 else g[:, :, None, :]

        gram4 = locus_major(ms.gram)
        graw4 = locus_major(graw) if use_raw else None
        coefs4 = tuple(group(c) for c in coefs)

        def step_body(ycorr, xs):
            t, mtb, cb = xs
            rows = mtb.reshape(V * B, mtb.shape[-1])
            r0, r0_raw = project(rows, cb.reshape(-1), ycorr)
            u, beta_new_b, outs = kernel(
                gram4, graw4, t, r0.reshape(V, B),
                None if r0_raw is None else r0_raw.reshape(V, B), *coefs4)
            correction = scatter(rows, u.reshape(-1)) - jnp.vdot(u, cb)
            return ycorr + ctx.psum(correction), (beta_new_b, outs)

        ycorr, (beta_new, outs) = lax.scan(
            step_body, ycorr, (jnp.arange(T, dtype=jnp.int32), mt4, cen))
        return ycorr, ungroup(beta_new), jax.tree.map(ungroup, outs)

    def scan_impl(gramb, grawb, r0, r0_raw, beta_old_b, lxs):
        return _block_scan(gramb, grawb, r0, r0_raw, beta_old_b, lxs, locus_fn, dtype)

    if ms.mt.ndim == 3:
        leaves = (ms.mt, ms.center, ms.gram, graw, ms.beta.reshape(ms.mpm.shape), locus_xs)

        def block_body(ycorr, xs):
            mtb, cb, gramb, grawb, beta_old_b, lxs = xs
            r0, r0_raw = project(mtb, cb, ycorr)
            u, beta_new_b, outs = scan_impl(
                gramb, grawb if use_raw else None, r0, r0_raw, beta_old_b, lxs)
            correction = scatter(mtb, u) - jnp.dot(u, cb)
            return ycorr + ctx.psum(correction), (beta_new_b, outs)

        ycorr, (beta_new, outs) = lax.scan(block_body, ycorr, leaves)
        return ycorr, beta_new.reshape(-1), outs

    # ---- virtual-shard path. Storage layouts (engine/plan.py): mt
    # (T, V, B, n), center (T, V, B), gram/gram_raw locus-major (T, B, V, B).
    # Small per-sweep arrays are re-grouped here (cheap); the big leaves are
    # consumed as pure scan slices.
    beta_g = group(ms.beta)
    lxs_g = jax.tree.map(group, locus_xs)

    def vscan(gram_t, graw_t, r0, r0_raw, beta_old_b, lxs):
        # gram_t is locus-major (B, V, B): vmap over the shard axis 1
        in2 = 1 if graw_t is not None else None
        in4 = 0 if r0_raw is not None else None
        return jax.vmap(scan_impl, in_axes=(1, in2, 0, in4, 0, 0))(
            gram_t, graw_t, r0, r0_raw, beta_old_b, lxs)

    def vblock_body(ycorr, xs):
        mtb, cb, gram_t, graw_t, beta_old_b, lxs = xs
        rows = mtb.reshape(V * B, mtb.shape[-1])
        r0, r0_raw = project(rows, cb.reshape(-1), ycorr)
        u, beta_new_b, outs = vscan(
            gram_t, graw_t if use_raw else None, r0.reshape(V, B),
            None if r0_raw is None else r0_raw.reshape(V, B), beta_old_b, lxs)
        correction = scatter(rows, u.reshape(-1)) - jnp.vdot(u, cb)
        return ycorr + ctx.psum(correction), (beta_new_b, outs)

    xs = (ms.mt, ms.center, ms.gram, graw, beta_g, lxs_g)
    ycorr, (beta_new, outs) = lax.scan(vblock_body, ycorr, xs)
    return ycorr, ungroup(beta_new), jax.tree.map(ungroup, outs)


# ------------------------------------------------------------------ BayesPR


def _gauss_effect_sweep(ms, mp: MarkerPlan, ycorr, var_e, d_inv, ctx, z,
                        ivb_locus, dtype):
    """Shared Gaussian effect update (BayesPR region priors and BayesLV
    per-locus priors differ only in where ivb_locus comes from):
    functions.jl:118-134 / :431-440. Returns (ycorr, beta)."""
    ive = 1.0 / var_e
    nb_l, p_l = _local_dims(ms, mp)

    lxs = tuple(_blockify_dev(a, nb_l, mp.block) for a in (z, ivb_locus)) + (
        ms.mpm, ms.lhs_ss, ms.rhs_ss, ms.mask)

    def locus_fn(pre, pre_raw, bold, lx):
        zj, ivbj, mpmj, lssj, rssj, maskj = lx
        rhs = pre * ive + rssj
        lhs = mpmj * ive + lssj + ivbj
        bnew = rhs / lhs + zj * jnp.sqrt(1.0 / lhs)
        return jnp.where(maskj, bnew, 0.0), None

    kernel, coefs = None, ()
    if mp.route == "triton":
        coefs = (gibbs_kernels.gauss_block_pack(
            ms.beta, z, ivb_locus, ms.mpm.reshape(-1), ms.lhs_ss.reshape(-1),
            ms.rhs_ss.reshape(-1), ms.mask.reshape(-1), ive),)

        def kernel(gram, graw, t, r0, r0r, head):
            beta_new, u = gibbs_kernels.gauss_block_scan(
                gram, t, r0, head, interpret=mp.interpret)
            return u.astype(dtype), beta_new.astype(dtype), None

    ycorr, beta, _ = _blocked_sweep(ms, ycorr, d_inv, locus_fn, lxs, dtype, False, ctx,
                                    mp.fused_passes, kernel, coefs)
    return ycorr, beta


def _sweep_pr(key, ms, mp: MarkerPlan, ycorr, var_e, d_inv, ctx):
    """sampleBayesPR! (functions.jl:118-137)."""
    dtype = ycorr.dtype
    kz, kv = jax.random.split(key)
    nb_l, p_l = _local_dims(ms, mp)
    z = _rnorm(kz, mp, ctx, p_l, dtype)
    ivb = jnp.where(ms.var_beta > 0, 1.0 / ms.var_beta, jnp.inf)
    ivb_locus = ivb[jnp.clip(ms.region_id, 0, mp.n_var - 1)]

    ycorr, beta = _gauss_effect_sweep(
        ms, mp, ycorr, var_e, d_inv, ctx, z, ivb_locus, dtype)

    # region variance update (functions.jl:135, sampleVarBetaPR :509-511)
    ss = ctx.psum(
        jax.ops.segment_sum(beta * beta, ms.region_id, num_segments=mp.n_var + 1)[: mp.n_var]
    )
    region_sizes = ctx.psum(
        jax.ops.segment_sum(
            ms.mask.reshape(-1).astype(dtype), ms.region_id, num_segments=mp.n_var + 1
        )[: mp.n_var]
    )
    chi = _chi2(kv, mp.df + region_sizes)
    var_beta = (ms.scale * mp.df + ss) / chi
    return replace(ms, beta=beta, var_beta=var_beta.astype(dtype)), ycorr


# ------------------------------------------------------------------ BayesB / BayesC


def _sweep_bc(key, ms, mp: MarkerPlan, ycorr, var_e, d_inv, common: bool, ctx):
    """sampleBayesB! (functions.jl:157-195) / sampleBayesC! (:197-236)."""
    dtype = ycorr.dtype
    kz, ku, kv, kp = jax.random.split(key, 4)
    nb_l, p_l = _local_dims(ms, mp)
    z = _rnorm(kz, mp, ctx, p_l, dtype)
    unif = _runif(ku, mp, ctx, p_l, dtype)
    ive = 1.0 / var_e
    lp0, lp1 = ms.log_pi[0], ms.log_pi[1]

    if common:
        vb_locus = jnp.full((p_l,), ms.var_beta[0], dtype)
    else:
        vb_locus = ms.var_beta.astype(dtype)
    ivb_locus = jnp.where(vb_locus > 0, 1.0 / vb_locus, jnp.inf)

    lxs = tuple(_blockify_dev(a, nb_l, mp.block) for a in (z, unif, vb_locus, ivb_locus)) + (
        ms.mpm, ms.lhs_ss, ms.rhs_ss, ms.mask)

    def locus_fn(pre, pre_raw, bold, lx):
        zj, uj, vbj, ivbj, mpmj, lssj, rssj, maskj = lx
        mpm_safe = jnp.where(maskj, mpmj, 1.0)
        rrr = pre_raw
        v0 = mpm_safe * var_e
        v1 = mpm_safe * mpm_safe * vbj + v0
        ld0 = -0.5 * (jnp.log(v0) + rrr * rrr / v0) + lp0
        ld1 = -0.5 * (jnp.log(v1) + rrr * rrr / v1) + lp1
        p1 = 1.0 / (1.0 + jnp.exp(ld0 - ld1))
        inc = uj < p1
        rhs = pre * ive + (0.0 if common else rssj)  # BayesC omits rhs_ss (functions.jl:219)
        lhs = mpm_safe * ive + lssj + ivbj
        b_inc = rhs / lhs + zj * jnp.sqrt(1.0 / lhs)
        bnew = jnp.where(inc & maskj, b_inc, 0.0)
        return bnew, (inc & maskj)

    kernel, coefs = None, ()
    if mp.route == "triton":
        weighted = d_inv is not None
        coefs = (gibbs_kernels.bc_block_pack(
            ms.beta, z, unif, vb_locus, ivb_locus,
            ms.mpm.reshape(-1), ms.lhs_ss.reshape(-1), ms.rhs_ss.reshape(-1),
            ms.mask.reshape(-1), ive, var_e, lp0, lp1, common,
            mpm_raw=_gram_raw_diag(ms) if weighted else None),)

        # weighted "D": the weighted Gram drives rhs, the raw Gram the
        # indicator's rrr (functions.jl:168; mme.jl:71-75)
        def kernel(gram, graw, t, r0, r0r, head):
            beta_new, u, delta = gibbs_kernels.bc_block_scan(
                gram, t, r0, head, graw=graw, r0_raw=r0r, interpret=mp.interpret)
            return u.astype(dtype), beta_new.astype(dtype), delta > 0

    ycorr, beta, inc = _blocked_sweep(ms, ycorr, d_inv, locus_fn, lxs, dtype, True, ctx,
                                      mp.fused_passes, kernel, coefs)
    delta = inc.reshape(-1).astype(jnp.int32)
    n_in = ctx.psum(jnp.sum(delta))

    if common:
        ss = ctx.psum(jnp.dot(beta, beta))  # all loci incl. zeros (functions.jl:230)
        var_beta = ((ms.scale * mp.df + ss) / _chi2(kv, mp.df + n_in)).reshape(1)
    else:
        chi = ctx.slice_p(_chi2(kv, jnp.full((mp.p_pad,), mp.df + 1.0)), p_l)
        vb = (ms.scale * mp.df + beta * beta) / chi  # per-locus (functions.jl:182)
        var_beta = jnp.where(delta == 1, vb, 0.0)

    out = replace(ms, beta=beta, delta=delta, var_beta=var_beta.astype(ms.var_beta.dtype))
    if mp.est_pi:  # samplePi Beta(nIn+1, nTotal-nIn+1) (functions.jl:531-533)
        pi_in = sample_beta_dist(kp, n_in + 1.0, mp.p - n_in + 1.0)
        pi_hat = jnp.stack([1.0 - pi_in, pi_in]).astype(dtype)
        out = replace(out, pi_hat=pi_hat, log_pi=jnp.log(pi_hat))
    return out, ycorr


# ------------------------------------------------------------------ BayesR


def _sweep_r(key, ms, mp: MarkerPlan, ycorr, var_e, d_inv, ctx):
    """sampleBayesR! (functions.jl:238-289)."""
    dtype = ycorr.dtype
    kz, ku, kv, kp = jax.random.split(key, 4)
    nb_l, p_l = _local_dims(ms, mp)
    K = mp.n_classes
    z = _rnorm(kz, mp, ctx, p_l, dtype)
    unif = _runif(ku, mp, ctx, p_l, dtype)
    ive = 1.0 / var_e
    varc = ms.var_beta[0] * ms.v_class  # (K,) (functions.jl:244)
    log_pi = ms.log_pi

    lxs = tuple(_blockify_dev(a, nb_l, mp.block) for a in (z, unif)) + (
        ms.mpm, ms.lhs_ss, ms.rhs_ss, ms.mask)

    def locus_fn(pre, pre_raw, bold, lx):
        zj, uj, mpmj, lssj, rssj, maskj = lx
        mpm_safe = jnp.where(maskj, mpmj, 1.0)
        rhs = pre * ive + rssj
        nz = varc > 0
        lhs_v = jnp.where(nz, mpm_safe * ive + lssj + 1.0 / jnp.where(nz, varc, 1.0), 0.0)
        logl = jnp.where(
            nz,
            -0.5 * (jnp.log(jnp.where(nz, varc * lhs_v, 1.0)) - rhs * rhs / jnp.where(nz, lhs_v, 1.0)),
            0.0,
        ) + log_pi
        logl = logl - jnp.max(logl)  # stabilized; probs invariant
        expl = jnp.exp(logl)
        probs = expl / jnp.sum(expl)
        cls = categorical_from_probs(uj, probs)
        lhs_sel = lhs_v[cls]
        sel_nz = varc[cls] > 0
        b_inc = rhs / lhs_sel + zj * jnp.sqrt(1.0 / lhs_sel)
        bnew = jnp.where(sel_nz & maskj, b_inc, 0.0)
        delta = jnp.where(maskj, cls + 1, 0)
        return bnew, delta.astype(jnp.int32)

    kernel, coefs = None, ()
    if mp.route == "triton":
        coefs = gibbs_kernels.r_block_pack(
            ms.beta, z, unif, ms.mpm.reshape(-1), ms.lhs_ss.reshape(-1),
            ms.rhs_ss.reshape(-1), ms.mask.reshape(-1), varc, log_pi, ive, var_e)

        def kernel(gram, graw, t, r0, r0r, head, cls):
            beta_new, u, delta = gibbs_kernels.r_block_scan(
                gram, t, r0, head, cls, K, interpret=mp.interpret)
            return u.astype(dtype), beta_new.astype(dtype), delta

    ycorr, beta, delta_b = _blocked_sweep(ms, ycorr, d_inv, locus_fn, lxs, dtype, False, ctx,
                                          mp.fused_passes, kernel, coefs)
    delta = delta_b.reshape(-1)
    cls0 = jnp.clip(delta - 1, 0, K - 1)
    vsel = ms.v_class[cls0]
    active = (delta > 0) & (vsel > 0)
    sum_s = ctx.psum(jnp.sum(jnp.where(active, beta * beta / jnp.where(active, vsel, 1.0), 0.0)))
    n_nz = ctx.psum(jnp.sum(active))
    var_beta = ((ms.scale * mp.df + sum_s) / _chi2(kv, mp.df + n_nz)).reshape(1)

    out = replace(ms, beta=beta, delta=delta, var_beta=var_beta.astype(ms.var_beta.dtype))
    if mp.est_pi:  # Dirichlet(nLoci .+ 1) (functions.jl:536-538)
        counts = ctx.psum(
            jnp.sum((delta[:, None] == jnp.arange(1, K + 1)[None, :]).astype(dtype), axis=0)
        )
        pi_hat = sample_dirichlet(kp, counts + 1.0).astype(dtype)
        out = replace(out, pi_hat=pi_hat, log_pi=jnp.log(pi_hat))
    return out, ycorr


# ------------------------------------------------------------------ BayesRCpi


def _sweep_rcpi(key, ms, mp: MarkerPlan, ycorr, var_e, d_inv, ctx):
    """sampleBayesRCpi! (functions.jl:291-360)."""
    dtype = ycorr.dtype
    kz, kua, kuv, kg1, kg2, kv, kp = jax.random.split(key, 7)
    nb_l, p_l = _local_dims(ms, mp)
    nA, K = mp.n_annot, mp.n_classes
    z = _rnorm(kz, mp, ctx, p_l, dtype)
    unif_a = _runif(kua, mp, ctx, p_l, dtype)
    unif_v = _runif(kuv, mp, ctx, p_l, dtype)
    # pre-generated Dirichlet gammas for sampleProb (functions.jl:541-544):
    # alpha = annotInput (+1 at the sampled annotation). annot_input is
    # REPLICATED across shards (parallel/sharded.py) so the gammas can be
    # drawn at global p_pad length and sliced per shard like every other
    # stream — a per-shard fold_in here made the sharded RCpi chain a
    # different chain from the single-device vshards run, breaking the
    # bit-equality invariant the multichip artifact certifies.
    a_in = ms.annot_input
    g1 = ctx.slice_p(jax.random.gamma(kg1, jnp.maximum(a_in, 1e-6)), p_l).astype(dtype)
    g2 = ctx.slice_p(jax.random.gamma(kg2, a_in + 1.0), p_l).astype(dtype)
    ive = 1.0 / var_e
    varc = ms.var_beta[:, None] * ms.v_class[None, :]  # (nA, K)
    log_pi = ms.log_pi  # (nA, K)
    nzc = varc > 0

    lxs = tuple(
        _blockify_dev(a, nb_l, mp.block)
        for a in (z, unif_a, unif_v, g1, g2, ms.annot_prob, ms.annot_nz)
    ) + (ms.mpm, ms.lhs_ss, ms.rhs_ss, ms.mask)

    def locus_fn(pre, pre_raw, bold, lx):
        zj, uaj, uvj, g1j, g2j, aprobj, anzj, mpmj, lssj, rssj, maskj = lx
        mpm_safe = jnp.where(maskj, mpmj, 1.0)
        rhs = pre * ive + rssj
        lhs_av = jnp.where(nzc, mpm_safe * ive + lssj + 1.0 / jnp.where(nzc, varc, 1.0), 0.0)
        logl = jnp.where(
            nzc,
            -0.5 * (jnp.log(jnp.where(nzc, varc * lhs_av, 1.0)) - rhs * rhs / jnp.where(nzc, lhs_av, 1.0)),
            0.0,
        ) + log_pi
        logl = logl - jnp.max(logl)  # one global shift; annot & class probs invariant
        expl = jnp.where(anzj[:, None], jnp.exp(logl), 0.0)  # non-zero annots only (functions.jl:307)
        rowsum = jnp.sum(expl, axis=1)
        pa = aprobj * rowsum
        pa = pa / jnp.sum(pa)
        a_sel = categorical_from_probs(uaj, pa)
        onehot_a = jnp.arange(nA) == a_sel
        gam = jnp.where(onehot_a, g2j, g1j) * anzj.astype(dtype)
        aprob_new = gam / jnp.sum(gam)
        aprob_new = jnp.where(maskj, aprob_new, aprobj)
        row = expl[a_sel]
        pv = row / jnp.sum(row)
        cls = categorical_from_probs(uvj, pv)
        lhs_sel = lhs_av[a_sel, cls]
        sel_nz = varc[a_sel, cls] > 0
        bnew = jnp.where(sel_nz & maskj, rhs / lhs_sel + zj * jnp.sqrt(1.0 / lhs_sel), 0.0)
        delta = jnp.where(maskj, cls + 1, 0).astype(jnp.int32)
        acat = jnp.where(maskj, a_sel + 1, 0).astype(jnp.int32)
        return bnew, (delta, acat, aprob_new)

    kernel, coefs = None, ()
    if mp.route == "triton":
        coefs = gibbs_kernels.rcpi_block_pack(
            ms.beta, z, unif_a, unif_v, g1.reshape(p_l, nA), g2.reshape(p_l, nA),
            ms.annot_prob.reshape(p_l, nA), ms.annot_nz.reshape(p_l, nA),
            ms.mpm.reshape(-1), ms.lhs_ss.reshape(-1), ms.rhs_ss.reshape(-1),
            ms.mask.reshape(-1), varc, log_pi, ive, var_e)

        def kernel(gram, graw, t, r0, r0r, head, cls, ann):
            beta_new, u, delta, acat, aprob = gibbs_kernels.rcpi_block_scan(
                gram, t, r0, head, cls, ann, nA, K, interpret=mp.interpret)
            return u.astype(dtype), beta_new.astype(dtype), (
                delta, acat, aprob.astype(dtype))

    ycorr, beta, outs = _blocked_sweep(ms, ycorr, d_inv, locus_fn, lxs, dtype, False, ctx,
                                       mp.fused_passes, kernel, coefs)
    delta = outs[0].reshape(-1)
    acat = outs[1].reshape(-1)
    annot_prob = outs[2].reshape(p_l, nA)

    cls0 = jnp.clip(delta - 1, 0, K - 1)
    a0 = jnp.clip(acat - 1, 0, nA - 1)
    vsel = ms.v_class[cls0]
    active = (delta > 0) & (vsel > 0)
    contrib = jnp.where(active, beta * beta / jnp.where(active, vsel, 1.0), 0.0)
    onehot_a = (a0[:, None] == jnp.arange(nA)[None, :]) & (acat > 0)[:, None]
    sum_s = ctx.psum(jnp.sum(jnp.where(onehot_a, contrib[:, None], 0.0), axis=0))  # (nA,)
    n_nz = ctx.psum(jnp.sum(onehot_a & active[:, None], axis=0))
    chi = _chi2(kv, mp.df + n_nz)
    var_beta = (ms.scale * mp.df + sum_s) / chi

    out = replace(
        ms, beta=beta, delta=delta, annot_cat=acat, annot_prob=annot_prob,
        var_beta=var_beta.astype(ms.var_beta.dtype),
    )
    if mp.est_pi:  # per-annotation Dirichlet over class counts (functions.jl:352-357)
        joint = (
            onehot_a[:, :, None]
            & (cls0[:, None, None] == jnp.arange(K)[None, None, :])
            & (delta > 0)[:, None, None]
        )
        counts = ctx.psum(jnp.sum(joint, axis=0).astype(dtype))  # (nA, K)
        pi_hat = sample_dirichlet(kp, counts + 1.0).astype(dtype)
        out = replace(out, pi_hat=pi_hat, log_pi=jnp.log(pi_hat))
    return out, ycorr


# ------------------------------------------------------------------ BayesRCplus


def _sweep_rcplus(key, ms, mp: MarkerPlan, ycorr, var_e, d_inv, ctx):
    """sampleBayesRCplus! (functions.jl:362-419): every non-zero annotation
    contributes an additive component to the locus effect; rhs is recomputed
    after each component since ycorr shifts (functions.jl:379,400).

    The own-coefficient exclusion of functions.jl:376 is recovered from the
    _block_scan convention (u_j = beta_old while locus j runs) by
    subtracting mpm_j*beta_old (mpm == Gram diagonal), so this sampler runs
    through the shared blocked sweep — vshards and device sharding included.
    """
    dtype = ycorr.dtype
    kz, ku, kv, kp = jax.random.split(key, 4)
    nb_l, p_l = _local_dims(ms, mp)
    nA, K = mp.n_annot, mp.n_classes
    z = _rnorm(kz, mp, ctx, p_l, dtype, extra=(nA,))
    unif = _runif(ku, mp, ctx, p_l, dtype, extra=(nA,))
    ive = 1.0 / var_e
    varc = ms.var_beta[:, None] * ms.v_class[None, :]  # (nA, K)
    log_pi = ms.log_pi

    lxs = tuple(_blockify_dev(a, nb_l, mp.block) for a in (z, unif, ms.annot_nz)) + (
        ms.mpm, ms.lhs_ss, ms.rhs_ss, ms.mask)

    def locus_fn(pre, pre_raw, bold, lx):
        zj, uj, anzj, mpmj, lssj, rssj, maskj = lx
        base = pre - mpmj * bold  # exclude own coefficient (functions.jl:376)
        mpm_safe = jnp.where(maskj, mpmj, 1.0)

        def annot_step(carry, ax):
            uj_c, temp_beta, delta_c = carry
            varc_a, log_pi_a, za, ua, anz_a = ax
            rhs = (base + mpmj * uj_c) * ive + rssj
            nz = varc_a > 0
            lhs_v = jnp.where(nz, mpm_safe * ive + lssj + 1.0 / jnp.where(nz, varc_a, 1.0), 0.0)
            logl = jnp.where(
                nz,
                -0.5 * (jnp.log(jnp.where(nz, varc_a * lhs_v, 1.0)) - rhs * rhs / jnp.where(nz, lhs_v, 1.0)),
                0.0,
            ) + log_pi_a
            logl = logl - jnp.max(logl)
            expl = jnp.exp(logl)
            cls = categorical_from_probs(ua, expl / jnp.sum(expl))
            active = anz_a & maskj
            sel_nz = nz[cls] & active
            lhs_sel = lhs_v[cls]
            bs = jnp.where(sel_nz, rhs / lhs_sel + za * jnp.sqrt(1.0 / lhs_sel), 0.0)
            uj_c = uj_c - bs
            temp_beta = temp_beta + bs
            delta_c = jnp.where(active, cls + 1, delta_c).astype(jnp.int32)
            return (uj_c, temp_beta, delta_c), (
                jnp.where(active, cls + 1, 0).astype(jnp.int32), bs, sel_nz)

        init = (bold, jnp.zeros((), dtype), jnp.zeros((), jnp.int32))
        (ujf, bnew, delta_j), (cls_a, bs_a, nz_a) = lax.scan(
            annot_step, init, (varc, log_pi, zj, uj, anzj))
        return bnew, (delta_j, cls_a, bs_a, nz_a)

    kernel, coefs = None, ()
    if mp.route == "triton":
        coefs = gibbs_kernels.rcplus_block_pack(
            ms.beta, z.reshape(p_l, nA), unif.reshape(p_l, nA),
            ms.annot_nz.reshape(p_l, nA), ms.mpm.reshape(-1),
            ms.lhs_ss.reshape(-1), ms.rhs_ss.reshape(-1), ms.mask.reshape(-1),
            varc, log_pi, ive, var_e)

        def kernel(gram, graw, t, r0, r0r, head, cls, ann):
            beta_new, u, delta, cls_a, bs_a, nz_a = gibbs_kernels.rcplus_block_scan(
                gram, t, r0, head, cls, ann, nA, K, interpret=mp.interpret)
            return u.astype(dtype), beta_new.astype(dtype), (
                delta, cls_a, bs_a.astype(dtype), nz_a > 0)

    ycorr, beta, outs = _blocked_sweep(ms, ycorr, d_inv, locus_fn, lxs, dtype, False, ctx,
                                       mp.fused_passes, kernel, coefs)
    delta = outs[0].reshape(-1)
    cls_a = outs[1].reshape(p_l, nA)
    bs_a = outs[2].reshape(p_l, nA)
    nz_a = outs[3].reshape(p_l, nA)

    cls0 = jnp.clip(cls_a - 1, 0, K - 1)
    vsel = ms.v_class[cls0]
    contrib = jnp.where(nz_a, bs_a * bs_a / jnp.where(nz_a, vsel, 1.0), 0.0)
    sum_s = ctx.psum(jnp.sum(contrib, axis=0))  # (nA,)
    n_nz = ctx.psum(jnp.sum(nz_a, axis=0))
    var_beta = (ms.scale * mp.df + sum_s) / _chi2(kv, mp.df + n_nz)

    out = replace(ms, beta=beta, delta=delta,
                  var_beta=var_beta.astype(ms.var_beta.dtype))
    if mp.est_pi:
        joint = (cls_a[:, :, None] == jnp.arange(1, K + 1)[None, None, :])
        counts = ctx.psum(jnp.sum(joint, axis=0).astype(dtype))
        pi_hat = sample_dirichlet(kp, counts + 1.0).astype(dtype)
        out = replace(out, pi_hat=pi_hat, log_pi=jnp.log(pi_hat))
    return out, ycorr


# ------------------------------------------------------------------ BayesLV


def _sweep_lv(key, ms, mp: MarkerPlan, ycorr, var_e, d_inv, ctx):
    """sampleBayesLV! (functions.jl:421-486): BayesPR-style effect update with
    per-locus variances, then the 3-auxiliary-variable bounded-uniform
    variance draw, the log-linear coefficient draw, and varZeta."""
    dtype = ycorr.dtype
    kz, ku, kc = jax.random.split(key, 3)
    nb_l, p_l = _local_dims(ms, mp)
    z = _rnorm(kz, mp, ctx, p_l, dtype)
    u4 = _runif(ku, mp, ctx, p_l, dtype, extra=(4,))
    ivb_locus = jnp.where(ms.var_beta > 0, 1.0 / ms.var_beta, jnp.inf).astype(dtype)

    ycorr, beta = _gauss_effect_sweep(
        ms, mp, ycorr, var_e, d_inv, ctx, z, ivb_locus, dtype)

    # ---- per-locus variance: bounded-uniform slice draw (functions.jl:444-470)
    vz = ms.var_zeta
    mask = ms.mask.reshape(-1)
    vari = jnp.where(mask, ms.var_beta, 1.0).astype(dtype)
    bi = beta
    logv = ms.log_var
    zeta = ms.lv_resid
    u1, u2, u3, uu = u4[:, 0], u4[:, 1], u4[:, 2], u4[:, 3]
    var_mui = logv - zeta
    c1 = vari ** (-1.5) * u1
    log_c2 = -0.5 * bi * bi / vari + jnp.log(u2)
    temp = jnp.sqrt(zeta * zeta - 2.0 * vz * jnp.log(u3))  # = sqrt(-2 vz log c3)
    lb = jnp.exp(var_mui - temp)
    rb = jnp.exp(var_mui + temp)
    rb = jnp.minimum(rb, jnp.exp((-2.0 / 3.0) * jnp.log(c1)))
    lb = jnp.maximum(lb, -0.5 * bi * bi / log_c2)
    trapped = lb >= rb
    newv = lb + uu * (rb - lb)
    upd = mask & ~trapped
    var_beta = jnp.where(upd, newv, ms.var_beta)
    log_var = jnp.where(upd, jnp.log(newv), ms.log_var)

    # ---- c ~ MvNormal(iCpC C' logVar, iCpC * varZeta) (functions.jl:473-476)
    zc = jax.random.normal(kc, (mp.n_lv_cov,), dtype)
    rhs_c = ctx.psum(ms.lv_design.T @ log_var)
    mean_c = ms.lv_icpc @ rhs_c
    c = mean_c + jnp.sqrt(vz) * (ms.lv_icpc_chol @ zc)
    resid = log_var - ms.lv_design @ c

    # ---- varZeta policy (functions.jl:479-485); sample variance (ddof=1)
    def _var(x):
        s1 = ctx.psum(jnp.sum(jnp.where(mask, x, 0.0)))
        s2 = ctx.psum(jnp.sum(jnp.where(mask, x * x, 0.0)))
        mean = s1 / mp.p
        return (s2 - mp.p * mean * mean) / (mp.p - 1)

    if isinstance(mp.est_var_zeta, bool):
        var_zeta = _var(resid) if mp.est_var_zeta else vz
    else:
        var_zeta = mp.est_var_zeta * _var(log_var)

    return (
        replace(ms, beta=beta, var_beta=var_beta, log_var=log_var, lv_c=c,
                lv_resid=resid, var_zeta=jnp.asarray(var_zeta, dtype)),
        ycorr,
    )


# ------------------------------------------------------ correlated marker sets


def sample_corr_marker_set(key, ms, cp, ycorr, var_e, ctx: ShardCtx = UNSHARDED):
    """Correlated marker sets, PR semantics (functions.jl:140-154): per-locus
    MvNormal across the nT sets, per-region InverseWishart covariance
    (sampleVarCovBetaPR, functions.jl:513-516). rhs has no summary stats and
    no weighting, as in the reference."""
    from ...ops.dists import sample_inv_wishart

    dtype = ycorr.dtype
    n_t = cp.n_t
    kz, kv = jax.random.split(key)
    nb_l = ms.mpm.shape[0]
    p_l = nb_l * cp.block
    z_full = jax.random.normal(kz, (cp.p_pad, n_t), dtype)
    z = ctx.slice_p(z_full, p_l)
    ive = 1.0 / var_e
    ivr = jnp.linalg.inv(ms.var_beta)  # (n_regions, nT, nT)
    ivr_locus = ivr[jnp.clip(ms.region_id, 0, cp.n_regions - 1)]  # (p_l, nT, nT)

    zb = z.reshape(nb_l, cp.block, n_t)
    ivb = ivr_locus.reshape(nb_l, cp.block, n_t, n_t)

    n_real = ycorr.shape[0]

    def block_update(ycorr, mtb, cb, gramb, mpmb, maskb, bold_b, zjb, ivbb):
        """One block's sequential locus scan against a frozen residual;
        returns (correction (n,), beta_new (B, nT))."""
        if mtb.dtype == jnp.uint8:  # 2-bit packed storage: exact unpack
            from ...ops import pack2

            mtf = pack2.unpack2(mtb, dtype)[..., :n_real]  # (B, nT, n)
        else:
            mtf = mtb.astype(dtype)  # (B, nT, n)
        sumy = jnp.sum(ycorr)
        r0 = jnp.einsum("ltn,n->lt", mtf, ycorr, precision=HI) - cb * sumy  # (B, nT)

        def body(u, xsj):
            j, r0j, bold, zj, ivbj, mpmj, maskj = xsj
            u = u.at[j].set(bold)
            pre = r0j + jnp.einsum("buv,bv->u", gramb[j], u, precision=HI)
            lhs = mpmj * ive + ivbj
            cov = jnp.linalg.inv(lhs)
            cov = (cov + jnp.swapaxes(cov, -1, -2)) / 2.0
            mean = cov @ (pre * ive)
            bnew = mean + jnp.linalg.cholesky(cov) @ zj
            bnew = jnp.where(maskj, bnew, 0.0)
            u = u.at[j].set(bold - bnew)
            return u, bnew

        u0 = jnp.zeros((cp.block, n_t), dtype)
        u, beta_new_b = lax.scan(
            body, u0,
            (jnp.arange(cp.block), r0, bold_b, zjb, ivbb, mpmb, maskb))
        correction = (jnp.einsum("lt,ltn->n", u, mtf, precision=HI)
                      - jnp.einsum("lt,lt->", u, cb))
        return correction, beta_new_b

    xs = (ms.mt, ms.center, ms.gram, ms.mpm, ms.mask,
          ms.beta.reshape(nb_l, cp.block, n_t), zb, ivb)

    # local virtual-shard count: chain v owns contiguous local blocks
    # [v*T, (v+1)*T); under device sharding each device holds its share
    # V_total / n_shards, so the composed schedule is the single-device
    # V_total-wide chain (same invariant as the plain marker path)
    V = getattr(cp, "vshards", 1)
    if ctx.axis is not None:
        V = max(1, V // ctx.n_shards)
    if V <= 1:
        def block_body(ycorr, xs_b):
            correction, beta_new_b = block_update(ycorr, *xs_b)
            return ycorr + ctx.psum(correction), beta_new_b

        ycorr, beta_b = lax.scan(block_body, ycorr, xs)
        beta = beta_b.reshape(p_l, n_t)
    else:
        T = nb_l // V

        def regroup(a):
            return jnp.swapaxes(a.reshape((V, T) + a.shape[1:]), 0, 1)

        xs_t = tuple(regroup(a) for a in xs)

        def superstep(ycorr, xs_v):  # each leaf (V, B, ...)
            corr_v, beta_v = jax.vmap(
                lambda *leaves: block_update(ycorr, *leaves))(*xs_v)
            return ycorr + ctx.psum(jnp.sum(corr_v, axis=0)), beta_v

        ycorr, beta_tv = lax.scan(superstep, ycorr, xs_t)  # (T, V, B, nT)
        beta = jnp.swapaxes(beta_tv, 0, 1).reshape(p_l, n_t)

    # per-region InverseWishart (functions.jl:152, :513-516)
    outer = beta[:, :, None] * beta[:, None, :]
    sb = ctx.psum(
        jax.ops.segment_sum(
            outer.reshape(p_l, -1), ms.region_id, num_segments=cp.n_regions + 1
        )[: cp.n_regions].reshape(cp.n_regions, n_t, n_t)
    )
    sizes = ctx.psum(
        jax.ops.segment_sum(
            ms.mask.reshape(-1).astype(dtype), ms.region_id, num_segments=cp.n_regions + 1
        )[: cp.n_regions]
    )
    keys = jax.random.split(kv, cp.n_regions)
    s_full = ms.scale[None] + sb
    s_full = (s_full + jnp.swapaxes(s_full, -1, -2)) / 2.0
    var_beta = jax.vmap(lambda k, d, s: sample_inv_wishart(k, d, s))(
        keys, cp.df + sizes, s_full
    ).astype(dtype)
    return replace(ms, beta=beta, var_beta=var_beta), ycorr


# ------------------------------------------------------------------ dispatch


def sample_marker_set(key, ms, mp: MarkerPlan, ycorr, var_e, d_inv, ctx: ShardCtx = UNSHARDED):
    if mp.method == METHOD_PR:
        return _sweep_pr(key, ms, mp, ycorr, var_e, d_inv, ctx)
    if mp.method == METHOD_B:
        return _sweep_bc(key, ms, mp, ycorr, var_e, d_inv, False, ctx)
    if mp.method == METHOD_C:
        return _sweep_bc(key, ms, mp, ycorr, var_e, d_inv, True, ctx)
    if mp.method == METHOD_R:
        return _sweep_r(key, ms, mp, ycorr, var_e, d_inv, ctx)
    if mp.method == METHOD_RCPI:
        return _sweep_rcpi(key, ms, mp, ycorr, var_e, d_inv, ctx)
    if mp.method == METHOD_RCPLUS:
        return _sweep_rcplus(key, ms, mp, ycorr, var_e, d_inv, ctx)
    if mp.method == METHOD_LV:
        return _sweep_lv(key, ms, mp, ycorr, var_e, d_inv, ctx)
    raise ValueError(f"unknown marker method {mp.method}")
