"""Gene-regulatory-network structural-equation MH-within-Gibbs sampler.

Method surface of `estGRN_MHGibbs` (/root/reference/src/GRN.jl:14-145):
    Y = mu + Lambda1 Y + Lambda2 Xc + e      (genes x individuals)
with gene-to-gene matrix Lambda1 (off-diagonals, Metropolis-Hastings with a
|det(I - Lambda1)|^(N/2) Jacobian target) and SNP-to-gene effects Lambda2
(single-site Gibbs over all SNPs per gene).

Re-design for the device: Lambda1's per-individual block design BIGM collapses
to dense algebra — the reference's regressors are the *initial* residual
matrix (GRN.jl:98 builds BIGM from yCorr before sampling and never rebuilds
it), so RHS over coefficient pairs (g,k) is (Ytil yCorr')[k,g] and
BIGM'BIGM is block-diagonal in YY' = Ytil Ytil' (GRN.jl:167-180). Lambda2's
per-gene scans are independent given the residual, so genes vmap while each
gene's SNP chain stays sequential through its Gram row correction — the
same blocked trick as the marker engine, with one block of all SNPs.

Hyper-parameters match GRN.jl:68-90: df = 4 everywhere, varLambda1 = 5e-4,
varBeta = 5e-4 per gene, scale = v*(df-2)/df.
"""
from __future__ import annotations

import functools

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..engine import rng as RNG
from ..io.writer import MCMCWriter, folder_handler
from ..utils import pytree_dataclass, replace


@pytree_dataclass
class GRNState:
    mu: jnp.ndarray  # (G,)
    lam1: jnp.ndarray  # (nL,) off-diagonal coefficients
    lam2: jnp.ndarray  # (G, S)
    var_lam1: jnp.ndarray  # ()
    var_beta: jnp.ndarray  # (G,)
    var_e: jnp.ndarray  # ()
    ycorr: jnp.ndarray  # (G, N)
    accept: jnp.ndarray  # () int32
    it: jnp.ndarray  # () int32


@dataclasses.dataclass(frozen=True)
class GRNPlan:
    n_genes: int
    n_snps: int
    n_ind: int
    mean_lam1: float
    nu_s_l1: float
    df_l1: float
    nu_s_beta: float
    df_beta: float
    nu_s_e: float
    df_e: float


def _pairs(G):
    """Off-diagonal coefficient ordering: (g, k) row-major, k != g.
    lam1[i] multiplies gene k's expression in gene g's equation."""
    return [(g, k) for g in range(G) for k in range(G) if k != g]


@functools.lru_cache(maxsize=8)
def _pairs_idx(G):
    """Cached (G(G-1), 2) index array: the O(G^2) Python pair list and the
    np conversion were rebuilt per kept sample in the output loop."""
    return np.array(_pairs(G))


def _lam1_matrix(lam1, G):
    idx = _pairs_idx(G)
    return jnp.zeros((G, G), lam1.dtype).at[idx[:, 0], idx[:, 1]].set(lam1)


def make_grn_step(plan: GRNPlan, xc, ytil, dtype=jnp.float64):
    """One MH-within-Gibbs iteration (GRN.jl:103-143).

    MpM[(g,k),(g',k')] = delta_gg' YY[k,k'] (GRN.jl:100) is block-diagonal
    in gene g, so the proposal covariance inverts as G batched
    (G-1) x (G-1) blocks instead of the reference's dense (G^2-G)^2 matrix
    — identical in exact arithmetic, and O(G^4) instead of O(G^6). G=100
    assembles and inverts in milliseconds. This vertical is a small dense
    problem and stays single-device by design (SURVEY.md §2.5)."""
    G, S, N = plan.n_genes, plan.n_snps, plan.n_ind
    pairs = _pairs_idx(G)
    n_l = len(pairs)
    yy = ytil @ ytil.T  # (G, G)
    excl = np.array([[k for k in range(G) if k != g] for g in range(G)])  # (G, G-1)
    excl_j = jnp.asarray(excl)
    yy_sub = yy[excl_j[:, :, None], excl_j[:, None, :]].astype(dtype)  # (G, G-1, G-1)
    gram_x = xc @ xc.T  # (S, S)
    xx = jnp.diagonal(gram_x)
    pair_g = jnp.asarray(pairs[:, 0])
    pair_k = jnp.asarray(pairs[:, 1])

    def step(state: GRNState, chain_key) -> GRNState:
        skey = RNG.sweep_key(chain_key, state.it)

        def k(i):
            return RNG.stage_key(skey, RNG.STAGE_GRN, i)

        ycorr = state.ycorr

        # 1) residual variance (GRN.jl:106, sampleVarE :245-247)
        ss = jnp.sum(ycorr * ycorr)
        var_e = (plan.nu_s_e + ss) / (2.0 * jax.random.gamma(k(0), (plan.df_e + G * N) / 2.0))

        # 2) gene means (GRN.jl:109-119)
        ycorr = ycorr + state.mu[:, None]
        mean_mu = jnp.sum(ycorr, axis=1) / N
        mu = mean_mu + jnp.sqrt(var_e / N) * jax.random.normal(k(1), (G,), dtype)
        ycorr = ycorr - mu[:, None]

        # 3) Lambda1 Metropolis-Hastings (GRN.jl:122,192-232) — batched over
        # the G diagonal blocks of MpM
        lam1_mat = _lam1_matrix(state.lam1, G)
        ycorr = ycorr + lam1_mat @ ytil
        ratio = var_e / state.var_lam1
        eye = jnp.eye(G - 1, dtype=dtype)
        ilhs = jnp.linalg.inv(yy_sub + ratio * eye[None])  # (G, G-1, G-1)
        yyc = ytil @ ycorr.T  # (G_k, G_g)
        rhs = (yyc[pair_k, pair_g] + plan.mean_lam1 * ratio).reshape(G, G - 1)
        lam_mean = jnp.einsum("gij,gj->gi", ilhs, rhs)  # (G, G-1)
        cov = ilhs * var_e
        cov = (cov + jnp.swapaxes(cov, 1, 2)) / 2.0
        chol = jnp.linalg.cholesky(cov)
        z1 = jax.random.normal(k(2), (n_l,), dtype).reshape(G, G - 1)
        prop = (lam_mean + jnp.einsum("gij,gj->gi", chol, z1)).reshape(-1)
        # icov has the closed form inv(ilhs*ve) = (yy_sub + ratio*I)/ve —
        # a second batched inversion would double the Lambda1 cost and add
        # round-trip inversion error to the MH quadratic
        icov = (yy_sub + ratio * eye[None]) / var_e
        lam_mean_flat = lam_mean.reshape(-1)

        def log_target(lam_vec):
            lam_m = _lam1_matrix(lam_vec, G)
            star = jnp.eye(G, dtype=dtype) - lam_m
            sign, logdet = jnp.linalg.slogdet(star)
            d = (lam_vec - lam_mean_flat).reshape(G, G - 1)
            return (N / 2.0) * logdet - 0.5 * jnp.einsum("gi,gij,gj->", d, icov, d)

        log_a = log_target(prop) - log_target(state.lam1)
        acc = jnp.log(jax.random.uniform(k(3), (), dtype)) < log_a
        lam1 = jnp.where(acc, prop, state.lam1)
        accept = state.accept + acc.astype(jnp.int32)
        lam1_mat = _lam1_matrix(lam1, G)
        ycorr = ycorr - lam1_mat @ ytil

        # 4) var(lambda1) (GRN.jl:125, :238-240)
        d1 = lam1 - plan.mean_lam1
        var_lam1 = (plan.nu_s_l1 + d1 @ d1) / (
            2.0 * jax.random.gamma(k(4), (plan.df_l1 + n_l) / 2.0)
        )

        # 5) Lambda2 single-site Gibbs, genes vmapped (GRN.jl:128,150-164)
        z2 = jax.random.normal(k(5), (G, S), dtype)
        # NOTE: the reference's prior-mean shift alpha*pMeans (GRN.jl:153-156)
        # is identically zero (pMeans = 0, GRN.jl:72), so the executed
        # conditional carries no shrinkage term — matched here explicitly

        def gene_scan(lam2_g, yc_g, z_g):
            r0 = xc @ yc_g  # (S,)

            def body(u, xs):
                q, grow, r0q, bold, zq = xs
                u = u.at[q].set(bold)
                # RHS = x_q . ycorr_g + alpha * prior mean (0, GRN.jl:72,156)
                rhs = r0q + grow @ u
                lhs = grow[q]  # x_q . x_q (GRN.jl:157)
                bnew = rhs / lhs + zq * jnp.sqrt(var_e / lhs)
                u = u.at[q].set(bold - bnew)
                return u, bnew

            u0 = jnp.zeros((S,), dtype)
            u, bnew = lax.scan(
                body, u0, (jnp.arange(S), gram_x, r0, lam2_g, z_g))
            yc_g = yc_g + u @ xc
            return bnew, yc_g

        lam2, ycorr = jax.vmap(gene_scan)(state.lam2, ycorr, z2)

        # 6) per-gene SNP-effect variances (GRN.jl:131-133, :242-244)
        ssb = jnp.sum(lam2 * lam2, axis=1)
        var_beta = (plan.nu_s_beta + ssb) / (
            2.0 * jax.random.gamma(k(6), jnp.full((G,), (plan.df_beta + S) / 2.0))
        )

        return replace(
            state, mu=mu, lam1=lam1, lam2=lam2, var_lam1=var_lam1,
            var_beta=var_beta, var_e=var_e, ycorr=ycorr, accept=accept,
            it=state.it + 1,
        )

    return step


def est_grn(
    x,
    y,
    n_genes: int,
    snp_per_gene: int,
    chain_length: int,
    burn_in: int,
    output_freq: int,
    start_lam1: Optional[np.ndarray] = None,
    mean_lam1: float = 0.0,
    start_lam2: Optional[np.ndarray] = None,
    prior_res: float = 1.0,
    out_folder: Optional[str] = "outMCMC",
    seed: int = 0,
    dtype=None,
):
    """estGRN_MHGibbs equivalent (GRN.jl:14-145). x: (nSNP, nInd) dosages;
    y: (nGenes, nInd) expression. Returns (acceptance count, draws dict).

    snp_per_gene is accepted for signature parity: the reference builds cis
    windows from it (SNPList, GRN.jl:32-38) but its sampleΛ2! nevertheless
    loops over ALL SNPs for every gene (GRN.jl:150-164) — SNPList is dead
    code there, and this implementation matches the executed behavior."""
    dtype = dtype or (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    G = n_genes
    S, N = x.shape
    xc = x - x.mean(axis=1, keepdims=True)  # GRN.jl:23
    n_l = G * G - G

    mu0 = y.mean(axis=1)  # GRN.jl:42
    lam1_0 = np.zeros(n_l) if start_lam1 is None else np.asarray(start_lam1, float)
    lam2_0 = np.zeros((G, S)) if start_lam2 is None else np.asarray(start_lam2, float)

    # hyperpriors (GRN.jl:68-90)
    df = 4.0
    var_lam1_0 = 5e-4
    var_beta_0 = 5e-4
    nu_s_l1 = var_lam1_0 * (df - 2.0)  # scale*df
    nu_s_beta = var_beta_0 * (df - 2.0)
    nu_s_e = prior_res * (df - 2.0)

    lam1_mat = np.asarray(_lam1_matrix(jnp.asarray(lam1_0), G))
    ycorr0 = y - mu0[:, None] - lam1_mat @ y - lam2_0 @ xc  # GRN.jl:95
    ytil = jnp.asarray(ycorr0, dtype)  # fixed regressors (GRN.jl:98, BIGM)

    plan = GRNPlan(
        n_genes=G, n_snps=S, n_ind=N, mean_lam1=float(mean_lam1),
        nu_s_l1=nu_s_l1, df_l1=df, nu_s_beta=nu_s_beta, df_beta=df,
        nu_s_e=nu_s_e, df_e=df,
    )
    state = GRNState(
        mu=jnp.asarray(mu0, dtype),
        lam1=jnp.asarray(lam1_0, dtype),
        lam2=jnp.asarray(lam2_0, dtype),
        var_lam1=jnp.asarray(var_lam1_0, dtype),
        var_beta=jnp.full((G,), var_beta_0, dtype),
        var_e=jnp.asarray(prior_res, dtype),
        ycorr=jnp.asarray(ycorr0, dtype),
        accept=jnp.asarray(0, jnp.int32),
        it=jnp.asarray(0, jnp.int32),
    )
    step = jax.jit(make_grn_step(plan, jnp.asarray(xc, dtype), ytil, dtype))
    key = jax.random.key(seed)

    writer = None
    if out_folder:
        folder_handler(out_folder)
        writer = MCMCWriter(out_folder)
    draws: dict = {}
    keep = set(range(burn_in + output_freq, chain_length + 1, output_freq))
    for it in range(1, chain_length + 1):
        state = step(state, key)
        if it in keep:
            sample = {
                "Lambda1": np.asarray(_lam1_matrix(state.lam1, G)).T.reshape(-1),
                "varLambda1": np.asarray(state.var_lam1).reshape(-1),
                "Lambda2": np.asarray(state.lam2).T.reshape(-1),
                "varBeta": np.asarray(state.var_beta),
                "varE": np.asarray(state.var_e).reshape(-1),
                "means": np.asarray(state.mu),
            }
            if writer:
                writer.put(sample)
            for nm, v in sample.items():
                draws.setdefault(nm, []).append(v)
    if writer:
        writer.close()
    return int(state.accept), {k: np.stack(v) for k, v in draws.items()}, state
