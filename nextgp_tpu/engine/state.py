"""ModelState pytrees — the device-resident Gibbs state.

This is the device-resident equivalent of the tuple `mme.getMME!` returns
(`/root/reference/src/mme.jl:603`): (ycorr, E, X, b, Z, u, varU, M, beta,
varBeta, delta) frozen into NamedTuples. Here each effect family is a
registered dataclass pytree; static shape/method facts live in the matching
*Plan dataclasses (engine/plan.py), which are hashable jit constants.

Marker sets are stored pre-blocked: the transposed marker matrix reshaped to
(n_blocks, block, n) so `lax.scan` streams one block at a time (the int8
HBM-resident layout of SURVEY.md §7.2), alongside the per-block centered
Gram matrices that make the in-block single-site scan exact (see
ops/blocked.py for the algebra).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from ..utils import pytree_dataclass

Array = Any


@pytree_dataclass
class FixedState:
    """One fixed-effect block (possibly a user-requested multi-variable block,
    mme.jl:98-126). xpx carries the ridge jitter of mme.jl:151."""

    x: Array  # (n, k)
    xp: Array  # (k, n)  = X' or (X .* d)' when weighted (mme.jl:136)
    xpx: Array  # (k, k) jittered
    lhs_ss: Array  # (k,) summary-stat precision offsets (mme.jl:144-147)
    rhs_ss: Array  # (k,)
    b: Array  # (k,)


@pytree_dataclass
class RandomState:
    """Univariate random effect (mme.jl:170-204)."""

    z: Array  # (n, q)
    zp: Array  # (q, n)
    zpz: Array  # (q,)
    ivstr: Array  # (q, q) inverse structure (I, A^-1, G^-1, user^-1)
    u: Array  # (q,)
    var_u: Array  # ()
    scale: Array  # ()


@pytree_dataclass
class SparseRandomState:
    """Scalable random effect for large level counts (production pedigrees):
    one-hot incidence held as a per-row level index, A^-1 as fixed-width
    padded sparse rows, and the Henderson factor (I-P)' D^-1/2 for exact
    N(0, A^-1) draws. Sampled by the perturbed-CG joint draw
    (engine/samplers/random_effects.py:sample_random_cg) instead of the
    per-level scan — no dense (n, q) or (q, q) arrays anywhere."""

    z_idx: Array  # (n,) int32 level per data row; -1 = no effect
    iv_idx: Array  # (q, K) int32 padded inverse-structure rows
    iv_val: Array  # (q, K)
    fac_sire: Array  # (q,) int32, -1 = unknown
    fac_dam: Array  # (q,) int32
    fac_dsqrt: Array  # (q,) D^-1/2 of the Henderson factorization
    u: Array  # (q,)
    var_u: Array  # ()
    scale: Array  # ()


@pytree_dataclass
class CorrRandomState:
    """Correlated random-effect group, tuple key in the reference
    (mme.jl:207-239; samplers functions.jl:75-110)."""

    zs: Array  # (nT, n, q) stacked component incidence columns
    zpz: Array  # (q, nT, nT) per-level cross-products
    ivstr: Array  # (q, q)
    u: Array  # (nT, q)
    var_u: Array  # (nT, nT)
    scale: Array  # (nT, nT)


@pytree_dataclass
class MarkerState:
    """One marker set in blocked layout. B = block size, nb = n_blocks.

    mt stores raw dosages (int8) or float markers, transposed and blocked:
    mt[b, j, :] is locus (b*B+j)'s genotype vector. Centered values are
    mt - center[..., None]; all kernels apply centering algebraically.
    """

    mt: Array  # (nb, B, n) int8 or float
    center: Array  # (nb, B)
    gram: Array  # (nb, B, B) centered (weighted) Gram blocks
    gram_raw: Optional[Array]  # unweighted Gram when residual is "D", else None
    mpm: Array  # (nb, B) diag of gram (weighted m'D^-1m, mme.jl:299-308)
    lhs_ss: Array  # (nb, B) summary-stat offsets (mme.jl:313-321)
    rhs_ss: Array  # (nb, B)
    mask: Array  # (nb, B) bool, False on padded loci
    region_id: Array  # (p_pad,) int32; padded loci -> n_regions
    beta: Array  # (p_pad,)
    delta: Array  # (p_pad,) int32 (1-based class/indicator as in reference)
    var_beta: Array  # (n_var,) regions / per-locus / classes / annotations
    scale: Array  # () prior scale (mme.jl:501-504)
    # mixture state (BayesB/C/R/RC*)
    log_pi: Optional[Array] = None  # (2,) | (K,) | (nA, K)
    pi_hat: Optional[Array] = None
    v_class: Optional[Array] = None  # (K,)
    # annotation state (BayesRCpi / BayesRCplus)
    annot_input: Optional[Array] = None  # (p_pad, nA) f32 = reference annotInput
    annot_prob: Optional[Array] = None  # (p_pad, nA) row-normalized
    annot_nz: Optional[Array] = None  # (p_pad, nA) bool
    annot_cat: Optional[Array] = None  # (p_pad,) int32
    # log-linear variance state (BayesLV, mme.jl:418-441)
    log_var: Optional[Array] = None  # (p_pad,)
    lv_design: Optional[Array] = None  # (p_pad, kC) variance-model design C
    lv_icpc: Optional[Array] = None  # (kC, kC) = inv(C'C + jitter)
    lv_icpc_chol: Optional[Array] = None  # chol(lv_icpc)
    lv_c: Optional[Array] = None  # (kC,)
    lv_resid: Optional[Array] = None  # (p_pad,) SNPVARRESID
    var_zeta: Optional[Array] = None  # ()


@pytree_dataclass
class CorrMarkerState:
    """Correlated marker sets, tuple key (M1, M2) in the reference
    (mme.jl:448-489; sampler functions.jl:140-154). Per locus the nT sets'
    columns form an (n, nT) block; the block-Gram carries (nT, nT)
    cross-products so the in-block scan stays exact."""

    mt: Array  # (nb, B, nT, n) raw dosages, or (nb, B, nT, q) uint8 2-bit packed
    center: Array  # (nb, B, nT)
    gram: Array  # (nb, B, B, nT, nT) centered cross-Grams
    mpm: Array  # (nb, B, nT, nT) per-locus M_l' M_l
    mask: Array  # (nb, B) bool
    region_id: Array  # (p_pad,) int32
    beta: Array  # (p_pad, nT)
    var_beta: Array  # (n_regions, nT, nT)
    scale: Array  # (nT, nT)


@pytree_dataclass
class ResidualState:
    """Residual variance bookkeeping (mme.jl:62-94). var_e is re-drawn each
    sweep from ycorr, so only priors + optional weights live here."""

    scale: Array  # ()
    d_inv: Optional[Array]  # (n,) 1/w weights when str == "D", else None
    var_e: Array  # () last drawn value (diagnostics/checkpointing)


@pytree_dataclass
class ModelState:
    y: Array  # (n,)
    ycorr: Array  # (n,)
    e: ResidualState
    fixed: Tuple[FixedState, ...]
    random: Tuple[Any, ...]  # RandomState | CorrRandomState
    markers: Tuple[MarkerState, ...]
    sweep_index: Array  # () int32 — for checkpoint/resume key derivation
    corr_markers: Tuple[CorrMarkerState, ...] = ()
