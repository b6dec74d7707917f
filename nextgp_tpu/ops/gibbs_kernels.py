"""Pallas kernels (Triton route) for the in-block single-site Gibbs scan.

The plain path (`engine/samplers/markers._block_scan`) runs the per-locus
chain as a `lax.scan` whose body is a handful of tiny operations; on a GPU
every iteration of that loop is at least one kernel launch, and a sweep
has p / V dependent iterations. These kernels run the whole B-locus chain
of one block inside one program instead:

  * grid (V,): one program per virtual chain. The V chains of a block step
    are independent, so they run side by side on the card's SMs;
  * a `fori_loop` over the B loci inside the program, with `u` (the
    pending residual correction) and the new effects carried as (B,)
    register vectors;
  * the Gram row of locus j is loaded from device memory at each step (a
    chain's B x B block outgrows shared memory but stays in L2 across the
    loop);
  * every input is indexed by the block step `t`, which the program loads
    itself: the caller's scan never slices the Gram or the coefficients.

Everything per locus that does not depend on the chain state is computed
outside the kernel as coefficients over all p loci (the `*_pack`
functions), transcendentals included:

  Gaussian (BayesPR/LV, functions.jl:124-134):
      beta_new = c + b * pre, with b = iVarE/lhs, c = rss/lhs + z*sqrt(1/lhs)
  BayesB/C indicator (functions.jl:171-173): u < 1/(1+e^t)  <=>
      q0 + q1*rrr^2 < log((1-u)/u)
  BayesR class scores (functions.jl:253-257): logl_k = q0_k + q1_k*pre^2

The restore (u_j <- beta_old_j) is folded into the head slot 0
(pre = r0 + row@u + gram_jj*beta_old, with u_j still 0 when locus j runs).

Coefficient layouts, all indexed [t, v, j, ...] (block step, chain, locus):
  head (8 slots) gauss: [adj, bold, b, c]
                 bc:    [adj, bold, q0, q1, w, b, c, adj_raw]
                 r:     [adj, bold, unif, mask]
                 rcpi:  [adj, bold, ua, uv, mask]
                 rcplus:[adj, bold, mask]
  cls (4, [A,] K) q0, q1, b, c per class (and annotation), padded to
                 powers of two (Triton's block shapes) with q0 = -1e30 so
                 padded classes carry no probability
  ann (n, A)     per-annotation rows: rcpi [aprob, g1, g2, anz],
                 rcplus [ua, anz]

The kernels consume the same pre-generated random streams as the plain
samplers, so both paths sample the same chain up to f32 rounding
(indicator decisions can flip only when a draw sits within rounding of
its threshold). Tests run them with interpret=True.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

F32 = jnp.float32
I32 = jnp.int32
_NEG = -1e30
NUM_WARPS = 1
NUM_STAGES = 2


def pow2(n: int) -> int:
    """Smallest power of two >= n (Triton block shapes)."""
    return 1 << max(0, int(n) - 1).bit_length()


def _head(*cols):
    cols = [jnp.asarray(c).astype(F32) for c in cols]
    pk = jnp.stack(cols, axis=-1)
    return jnp.pad(pk, ((0, 0), (0, 8 - pk.shape[-1])))


def _pad_last(x, size, fill=0.0):
    pad = size - x.shape[-1]
    if pad <= 0:
        return x.astype(F32)
    widths = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
    return jnp.pad(x.astype(F32), widths, constant_values=fill)


def _class_coefs(mpm, lss, mask, varc, logpi, ive, z, active):
    """(p, 4, ..., K) rows q0, q1, b, c of the class scores. varc/logpi are
    (K,) or (A, K); z is (p,) or (p, A); active masks b and c."""
    nz = varc > 0
    varc_s = jnp.where(nz, varc, 1.0)
    mpm_safe = jnp.where(mask, mpm, 1.0)
    ex = (slice(None),) + (None,) * varc.ndim
    lhs = jnp.where(nz, mpm_safe[ex] * ive + lss[ex] + 1.0 / varc_s, 0.0)
    lhs_s = jnp.where(nz, lhs, 1.0)
    invlhs = jnp.where(nz, 1.0 / lhs_s, 0.0)
    q0 = jnp.where(nz, -0.5 * jnp.log(varc_s * lhs_s), 0.0) + logpi
    q1 = 0.5 * invlhs * ive * ive
    act = active[..., None]
    bco = jnp.where(act, ive * invlhs, 0.0)
    cco = jnp.where(act, z[..., None] * jnp.sqrt(invlhs), 0.0)
    Kp = pow2(varc.shape[-1])
    q0 = _pad_last(jnp.broadcast_to(q0, bco.shape), Kp, _NEG)
    rest = [_pad_last(jnp.broadcast_to(x, bco.shape), Kp) for x in (q1, bco, cco)]
    return jnp.stack([q0] + rest, axis=1)


# ------------------------------------------------------------ coefficients


@jax.jit
def gauss_block_pack(beta_old, z, ivb, mpm, lss, rss, mask, ive):
    lhs = mpm * ive + lss + ivb
    invlhs = 1.0 / lhs
    b = jnp.where(mask, ive * invlhs, 0.0)
    c = jnp.where(mask, rss * invlhs + z * jnp.sqrt(invlhs), 0.0)
    return _head(mpm * beta_old, beta_old, b, c)


@functools.partial(jax.jit, static_argnames=("common",))
def bc_block_pack(beta_old, z, unif, vb, ivb, mpm, lss, rss, mask, ive, var_e,
                  lp0, lp1, common, mpm_raw=None):
    """BayesB/C coefficients. The indicator u < 1/(1+exp(ld0-ld1)) becomes
    q0 + q1*rrr^2 < log((1-u)/u) (functions.jl:171-173, exact algebra).

    mpm_raw (weighted "D" models only): the raw per-locus m'm diagonal —
    slot 7 then carries the raw restore adjustment for the indicator's rrr
    (functions.jl:168: rrr is the unweighted dot even when mpm is
    weighted)."""
    mpm_safe = jnp.where(mask, mpm, 1.0)
    v0 = mpm_safe * var_e
    v1 = mpm_safe * mpm_safe * vb + v0
    q0 = -0.5 * (jnp.log(v0) - jnp.log(v1)) + lp0 - lp1
    q0 = jnp.where(mask, q0, jnp.inf)  # padded loci never included
    q1 = -0.5 * (1.0 / v0 - 1.0 / v1)
    w = jnp.log1p(-unif) - jnp.log(unif)
    lhs = mpm_safe * ive + lss + ivb  # ivb = inf when vb == 0 -> b = c = 0
    invlhs = 1.0 / lhs
    b = ive * invlhs
    rss_eff = 0.0 if common else rss  # BayesC omits rhs_ss (functions.jl:219)
    c = rss_eff * invlhs + z * jnp.sqrt(invlhs)
    raw = mpm_raw * beta_old if mpm_raw is not None else jnp.zeros_like(beta_old)
    return _head(mpm * beta_old, beta_old, q0, q1, w, b, c, raw)


@jax.jit
def r_block_pack(beta_old, z, unif, mpm, lss, rss, mask, varc, logpi, ive, var_e):
    """BayesR: logl_k = q0_k + q1_k*pre^2 with rss folded into the additive
    slot (rhs = (r0 + dot + mpm*bold + rss*varE) * iVarE)."""
    head = _head(mpm * beta_old + rss * var_e, beta_old, unif, mask)
    cls = _class_coefs(mpm, lss, mask, varc, logpi, ive, z, mask)
    return head, cls


@jax.jit
def rcpi_block_pack(beta_old, z, ua, uv, g1, g2, aprob, anz, mpm, lss, rss,
                    mask, varc, logpi, ive, var_e):
    A = varc.shape[0]
    Ap = pow2(A)
    head = _head(mpm * beta_old + rss * var_e, beta_old, ua, uv, mask)
    zA = jnp.broadcast_to(z[:, None], (z.shape[0], A))
    actA = jnp.broadcast_to(mask[:, None], zA.shape)
    cls = _class_coefs(mpm, lss, mask, varc, logpi, ive, zA, actA)
    cls = jnp.pad(cls, ((0, 0), (0, 0), (0, Ap - A), (0, 0)))
    cls = cls.at[:, 0, A:, :].set(_NEG)
    ann = jnp.stack([_pad_last(x, Ap) for x in (aprob, g1, g2, anz)], axis=1)
    return head, cls, ann


@jax.jit
def rcplus_block_pack(beta_old, z, ua, anz, mpm, lss, rss, mask, varc, logpi,
                      ive, var_e):
    A = varc.shape[0]
    Ap = pow2(A)
    head = _head(rss * var_e, beta_old, mask)
    cls = _class_coefs(mpm, lss, mask, varc, logpi, ive, z, mask[:, None] & anz)
    cls = jnp.pad(cls, ((0, 0), (0, 0), (0, Ap - A), (0, 0)))
    ann = jnp.stack([_pad_last(x, Ap) for x in (ua, anz)], axis=1)
    return head, cls, ann


# ------------------------------------------------------------ kernel frame


def _frame(locus, n_gram, n_in, n_int):
    """Kernel for one virtual chain v = program_id(0) at block step t.

    Refs: t (1,), n_gram Gram streams (T, B, V, B), r0 (V, B), r0_raw when
    n_gram == 2, n_in coefficient arrays (T, V, B, ...); outputs beta and u
    (V, B) f32, n_int (V, B) int32 and any per-locus row outputs.
    locus(v, j, t, dots, pres, ins, rows) -> (bnew, u_j, ints)."""

    def kernel(t_ref, *refs):
        grams = refs[:n_gram]
        r0s = refs[n_gram:2 * n_gram]
        ins = refs[2 * n_gram:2 * n_gram + n_in]
        beta_ref, u_ref, *outs = refs[2 * n_gram + n_in:]
        int_refs, rows = outs[:n_int], outs[n_int:]
        v = pl.program_id(0)
        t = t_ref[0]
        B = u_ref.shape[1]
        lane = lax.broadcasted_iota(I32, (B,), 0)

        def body(j, carry):
            u, beta, ints = carry
            dots = tuple(jnp.sum(g[t, j, v, :] * u) for g in grams)
            pres = tuple(r[v, j] for r in r0s)
            bnew, uj, ivals = locus(v, j, t, dots, pres, ins, rows, grams)
            sel = lane == j
            u = jnp.where(sel, uj, u)
            beta = jnp.where(sel, bnew, beta)
            ints = tuple(jnp.where(sel, x, c) for x, c in zip(ivals, ints))
            return u, beta, ints

        zero = jnp.zeros((B,), F32)
        init = (zero, zero, tuple(jnp.zeros((B,), I32) for _ in int_refs))
        u, beta, ints = lax.fori_loop(0, B, body, init)
        beta_ref[v, :] = beta
        u_ref[v, :] = u
        for r, x in zip(int_refs, ints):
            r[v, :] = x

    return kernel


def _call(name, kernel, grams, r0s, t, ins, n_int, rows=(), interpret=False):
    T, B, V, _ = grams[0].shape
    outs = ([jax.ShapeDtypeStruct((V, B), F32)] * 2
            + [jax.ShapeDtypeStruct((V, B), I32)] * n_int
            + [jax.ShapeDtypeStruct((V, B) + s, d) for s, d in rows])
    return pl.pallas_call(
        kernel,
        out_shape=tuple(outs),
        grid=(V,),
        interpret=interpret,
        name=name,
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
    )(jnp.asarray(t, I32).reshape(1),
      *[g.astype(F32) for g in grams], *[r.astype(F32) for r in r0s],
      *[x.astype(F32) for x in ins])


def _cdf_draw(probs, u, n):
    """Inverse-CDF draw over the last axis (categorical_from_probs)."""
    cls = jnp.sum((jnp.cumsum(probs) < u).astype(I32))
    return jnp.minimum(cls, n - 1)


# ------------------------------------------------------------ the six scans
#
# Shapes: gram/graw (T, B, V, B) locus-major, r0 (V, B), coefficients
# (T, V, B, ...). Each returns (beta (V, B), u (V, B), ...).


def _gauss_locus(v, j, t, dots, pres, ins, rows, grams):
    (hd,) = ins
    pre = pres[0] + hd[t, v, j, 0] + dots[0]
    bnew = hd[t, v, j, 3] + hd[t, v, j, 2] * pre
    return bnew, hd[t, v, j, 1] - bnew, ()


def gauss_block_scan(gram, t, r0, head, interpret=False):
    return _call("gibbs_scan_gauss", _frame(_gauss_locus, 1, 1, 0),
                 (gram,), (r0,), t, (head,), 0, interpret=interpret)


def _bc_locus(v, j, t, dots, pres, ins, rows, grams):
    (hd,) = ins
    pre = pres[0] + hd[t, v, j, 0] + dots[0]
    rrr = pres[1] + hd[t, v, j, 7] + dots[1] if len(dots) == 2 else pre
    inc = hd[t, v, j, 2] + hd[t, v, j, 3] * rrr * rrr < hd[t, v, j, 4]
    bnew = jnp.where(inc, hd[t, v, j, 6] + hd[t, v, j, 5] * pre, 0.0)
    return bnew, hd[t, v, j, 1] - bnew, (inc.astype(I32),)


def bc_block_scan(gram, t, r0, head, graw=None, r0_raw=None, interpret=False):
    """BayesB/C. Weighted "D" models pass the raw Gram and raw r0: the
    weighted Gram drives rhs, the raw one the indicator's rrr
    (mme.jl:71-75, functions.jl:168)."""
    grams, r0s = ((gram,), (r0,)) if graw is None else ((gram, graw), (r0, r0_raw))
    name = "gibbs_scan_bc" if graw is None else "gibbs_scan_bc_w"
    return _call(name, _frame(_bc_locus, len(grams), 1, 1),
                 grams, r0s, t, (head,), 1, interpret=interpret)


def _make_r_locus(K):
    def locus(v, j, t, dots, pres, ins, rows, grams):
        hd, cf = ins
        pre = pres[0] + hd[t, v, j, 0] + dots[0]
        q0, q1, bco, cco = (cf[t, v, j, i, :] for i in range(4))
        logl = q0 + q1 * (pre * pre)
        e = jnp.exp(logl - jnp.max(logl))
        cls = _cdf_draw(e / jnp.sum(e), hd[t, v, j, 2], K)
        hot = lax.broadcasted_iota(I32, q0.shape, 0) == cls
        bnew = jnp.sum(jnp.where(hot, cco + bco * pre, 0.0))
        delta = jnp.where(hd[t, v, j, 3] != 0, cls + 1, 0).astype(I32)
        return bnew, hd[t, v, j, 1] - bnew, (delta,)

    return locus


def r_block_scan(gram, t, r0, head, cls, n_classes, interpret=False):
    return _call("gibbs_scan_r", _frame(_make_r_locus(n_classes), 1, 2, 1),
                 (gram,), (r0,), t, (head, cls), 1, interpret=interpret)


def _make_rcpi_locus(A, K):
    def locus(v, j, t, dots, pres, ins, rows, grams):
        hd, cf, an = ins
        (aprob_ref,) = rows
        pre = pres[0] + hd[t, v, j, 0] + dots[0]
        q0, q1, bco, cco = (cf[t, v, j, i, :, :] for i in range(4))  # (Ap, Kp)
        aprob, g1, g2, anz = (an[t, v, j, i, :] for i in range(4))  # (Ap,)
        logl = q0 + q1 * (pre * pre)
        e = jnp.exp(logl - jnp.max(logl)) * anz[:, None]
        pa = aprob * jnp.sum(e, axis=1)
        a_sel = _cdf_draw(pa / jnp.sum(pa), hd[t, v, j, 2], A)
        in_row = lax.broadcasted_iota(I32, aprob.shape, 0) == a_sel
        row = jnp.sum(jnp.where(in_row[:, None], e, 0.0), axis=0)
        cls = _cdf_draw(row / jnp.sum(row), hd[t, v, j, 3], K)
        hot = in_row[:, None] & (lax.broadcasted_iota(I32, q0.shape, 1) == cls)
        bnew = jnp.sum(jnp.where(hot, cco + bco * pre, 0.0))
        gam = jnp.where(in_row, g2, g1) * anz
        masked = hd[t, v, j, 4] != 0
        aprob_ref[v, j, :] = jnp.where(masked, gam / jnp.sum(gam), aprob)
        delta = jnp.where(masked, cls + 1, 0).astype(I32)
        acat = jnp.where(masked, a_sel + 1, 0).astype(I32)
        return bnew, hd[t, v, j, 1] - bnew, (delta, acat)

    return locus


def rcpi_block_scan(gram, t, r0, head, cls, ann, n_annot, n_classes,
                    interpret=False):
    """Returns beta, u, delta, acat (V, B) and the updated annotation
    probabilities (V, B, A)."""
    Ap = ann.shape[-1]
    out = _call("gibbs_scan_rcpi", _frame(_make_rcpi_locus(n_annot, n_classes), 1, 3, 2),
                (gram,), (r0,), t, (head, cls, ann), 2, rows=(((Ap,), F32),),
                interpret=interpret)
    return out[:4] + (out[4][..., :n_annot],)


def _make_rcplus_locus(A, K):
    def locus(v, j, t, dots, pres, ins, rows, grams):
        hd, cf, an = ins
        cls_ref, bs_ref, nz_ref = rows
        base = pres[0] + hd[t, v, j, 0] + dots[0]  # own coefficient excluded (u_j = 0)
        gjj = grams[0][t, j, v, j]
        masked = hd[t, v, j, 2] != 0
        ujc = hd[t, v, j, 1]
        tempb = jnp.zeros((), F32)
        deltaj = jnp.zeros((), I32)
        Ap = cf.shape[-2]
        aiota = lax.broadcasted_iota(I32, (Ap,), 0)
        clsA = jnp.zeros((Ap,), I32)
        bsA = jnp.zeros((Ap,), F32)
        nzA = jnp.zeros((Ap,), I32)
        for a in range(A):  # additive components, in annotation order
            prea = base + gjj * ujc
            q0, q1, bco, cco = (cf[t, v, j, i, a, :] for i in range(4))
            logl = q0 + q1 * (prea * prea)
            ek = jnp.exp(logl - jnp.max(logl))
            cls = _cdf_draw(ek / jnp.sum(ek), an[t, v, j, 0, a], K)
            hot = lax.broadcasted_iota(I32, q0.shape, 0) == cls
            sel_nz = jnp.sum(jnp.where(hot, bco, 0.0)) > 0.0  # b is 0 for null/inactive
            bs = jnp.sum(jnp.where(hot, cco + bco * prea, 0.0))
            active = (an[t, v, j, 1, a] != 0) & masked
            ujc = ujc - bs
            tempb = tempb + bs
            deltaj = jnp.where(active, cls + 1, deltaj).astype(I32)
            hot_a = aiota == a
            clsA = jnp.where(hot_a, jnp.where(active, cls + 1, 0), clsA).astype(I32)
            bsA = jnp.where(hot_a, bs, bsA)
            nzA = jnp.where(hot_a, sel_nz.astype(I32), nzA)
        cls_ref[v, j, :] = clsA
        bs_ref[v, j, :] = bsA
        nz_ref[v, j, :] = nzA
        return tempb, ujc, (deltaj,)

    return locus


def rcplus_block_scan(gram, t, r0, head, cls, ann, n_annot, n_classes,
                      interpret=False):
    """Returns beta, u, delta (V, B) and per-annotation class, component
    and inclusion (V, B, A)."""
    Ap = ann.shape[-1]
    out = _call("gibbs_scan_rcplus", _frame(_make_rcplus_locus(n_annot, n_classes), 1, 3, 1),
                (gram,), (r0,), t, (head, cls, ann), 1,
                rows=(((Ap,), I32), ((Ap,), F32), ((Ap,), I32)),
                interpret=interpret)
    return out[:3] + tuple(x[..., :n_annot] for x in out[3:])
