"""Virtual-shard schedule (assemble(vshards=V)): V block chains advance per
block-step, the on-chip analog of the multi-device sharded sweep.

Invariants tested on the CPU:
  * residual consistency: ycorr always equals y - Xb - M beta exactly
  * pure-JAX vshards == Triton-route kernels (Pallas interpreter) from the
    same streams
  * vshards run recovers the same posterior signal as the sequential run
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nextgp_tpu as ng
from nextgp_tpu import backend

# the Triton-route scan kernels, run in the Pallas interpreter on the CPU
KERNELS = {"route": "triton", "interpret": True}


def _spec(rng, n=80, p=96, method="BayesR"):
    g = rng.integers(0, 3, (n, p)).astype(float)
    gc = g - g.mean(0)
    bt = np.zeros(p)
    bt[rng.choice(p, 10, replace=False)] = rng.normal(0, 0.4, 10)
    y = 1.0 + gc @ bt + rng.normal(0, 1, n)
    priors = {
        "BayesPR": ng.BayesPR(9999, 0.05),
        "BayesB": ng.BayesB(0.1, 0.05, estimatePi=True),
        "BayesC": ng.BayesC(0.1, 0.05, estimatePi=True),
        "BayesR": ng.BayesR([0.8, 0.1, 0.1], [0.0, 0.01, 0.1], 1.0, estimatePi=True),
        "BayesRCpi": ng.BayesRCpi(
            [0.8, 0.1, 0.1], [0.0, 0.01, 0.1], 1.0,
            rng.integers(0, 2, (p, 2)) | np.array([1, 0]),
        ),
        "BayesRCplus": ng.BayesRCplus(
            [0.8, 0.1, 0.1], [0.0, 0.01, 0.1], 1.0,
            rng.integers(0, 2, (p, 2)) | np.array([1, 0]),
        ),
        "BayesLV": ng.BayesLV(
            0.05, np.column_stack([np.ones(p), rng.normal(0, 1, p)]), 0.1,
            estimateVarZeta=False,
        ),
    }
    spec = ng.ModelSpec(
        y=y,
        fixed=[ng.FixedTerm("int", np.ones(n))],
        markers=[ng.MarkerTerm("M", ng.from_array(g), priors[method])],
        block_size=16,  # nb = 6 blocks
    )
    return spec, gc, bt


def _run(spec, n_sweeps=30, **kw):
    plan, state = ng.assemble(spec, **kw)
    sweep = jax.jit(ng.make_sweep(plan))
    key = jax.random.key(9)
    for _ in range(n_sweeps):
        state = sweep(state, key)
    return plan, state


@pytest.mark.parametrize(
    "method", ["BayesPR", "BayesB", "BayesC", "BayesR", "BayesRCpi", "BayesRCplus"]
)
def test_vshards_residual_exact(rng, method):
    spec, gc, _ = _spec(rng, method=method)
    plan, state = _run(spec, vshards=3)
    assert plan.markers[0].vshards == 3
    p = plan.markers[0].p
    beta = np.asarray(state.markers[0].beta[:p])
    recon = spec.y - np.asarray(state.fixed[0].b)[0] - gc @ beta
    drift = np.abs(np.asarray(state.ycorr) - recon).max()
    assert drift < 1e-8


@pytest.mark.parametrize(
    "method", ["BayesPR", "BayesB", "BayesC", "BayesR", "BayesRCpi", "BayesRCplus"]
)
def test_vshards_pallas_matches_pure_jax(rng, method):
    spec, _, _ = _spec(rng, method=method)
    _, st_jax = _run(spec, n_sweeps=10, vshards=3, route="xla")
    _, st_pal = _run(spec, n_sweeps=10, vshards=3, **KERNELS)
    np.testing.assert_allclose(
        np.asarray(st_jax.markers[0].beta),
        np.asarray(st_pal.markers[0].beta),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(st_jax.ycorr), np.asarray(st_pal.ycorr), atol=1e-5
    )


@pytest.mark.parametrize("method", ["BayesRCpi", "BayesRCplus"])
def test_rc_pallas_matches_pure_jax_sequential(rng, method):
    """Single-chain (vshards=1) RC kernels vs pure JAX from shared streams."""
    spec, _, _ = _spec(rng, method=method)
    _, st_jax = _run(spec, n_sweeps=10, route="xla")
    _, st_pal = _run(spec, n_sweeps=10, **KERNELS)
    np.testing.assert_allclose(
        np.asarray(st_jax.markers[0].beta),
        np.asarray(st_pal.markers[0].beta),
        atol=1e-5,
    )
    assert np.array_equal(
        np.asarray(st_jax.markers[0].delta), np.asarray(st_pal.markers[0].delta)
    )
    np.testing.assert_allclose(
        np.asarray(st_jax.ycorr), np.asarray(st_pal.ycorr), atol=1e-5
    )
    if method == "BayesRCpi":
        np.testing.assert_allclose(
            np.asarray(st_jax.markers[0].annot_prob),
            np.asarray(st_pal.markers[0].annot_prob),
            atol=1e-5,
        )
        assert np.array_equal(
            np.asarray(st_jax.markers[0].annot_cat),
            np.asarray(st_pal.markers[0].annot_cat),
        )


def test_vshards_recovers_signal(rng):
    spec, gc, bt = _spec(rng, n=200, p=96)
    plan, state = ng.assemble(spec, vshards=6)
    sweep = jax.jit(ng.make_sweep(plan))
    key = jax.random.key(4)
    p = plan.markers[0].p
    bsum = np.zeros(p)
    cnt = 0
    for i in range(250):
        state = sweep(state, key)
        if i >= 100:
            bsum += np.asarray(state.markers[0].beta[:p])
            cnt += 1
    corr = np.corrcoef(gc @ (bsum / cnt), gc @ bt)[0, 1]
    assert corr > 0.75


def test_vshards_fallback_when_indivisible(rng):
    spec, _, _ = _spec(rng)
    with pytest.warns(UserWarning, match="largest divisor"):
        plan, _ = ng.assemble(spec, vshards=5)  # nb=6 -> V floors to 3
    assert plan.markers[0].vshards == 3


def test_vshards_auto(rng):
    """vshards="auto": reference order (V=1) on the CPU whatever the scan
    route; the platform, not the route, decides."""
    spec, _, _ = _spec(rng, method="BayesR")  # p=96, block 16 -> nb=6
    plan, _ = ng.assemble(spec, vshards="auto")
    assert plan.markers[0].vshards == 1
    plan, state = ng.assemble(spec, vshards="auto", **KERNELS)
    assert plan.markers[0].vshards == 1 and state.markers[0].mt.ndim == 3
    assert backend.auto_vshards(6, "gpu") == 6


@pytest.mark.parametrize("nb,want", [
    (192, 96),   # 10k x 49,152 at B=256
    (144, 72),   # 50k x 36,864
    (2304, 128),  # 50k x 589,824
    (232, 116),  # 8 * prime: the largest divisor, not the largest %8 one
    (7, 7), (1, 1),
])
def test_auto_vshards_gpu_rule(nb, want):
    """GPU auto-V: the largest divisor of the block count up to
    GPU_MAX_VSHARDS; every other platform keeps V=1."""
    assert backend.auto_vshards(nb, "gpu") == want
    assert backend.auto_vshards(nb, "cpu") == 1


def test_run_lmem_default_is_auto(rng, tmp_path):
    """run_lmem with no vshards argument resolves the production default:
    V=1 on CPU (reference-sequential), the GPU rule on the card."""
    import inspect

    from nextgp_tpu.runtime import run_chains, run_lmem

    assert inspect.signature(run_lmem).parameters["vshards"].default == "auto"
    assert inspect.signature(run_chains).parameters["vshards"].default == "auto"
    spec, _, _ = _spec(rng, method="BayesR")
    res = run_lmem(spec, n_chain=4, n_burn=2, n_thin=2, out_folder=None)
    assert res.plan.markers[0].vshards == 1  # CPU backend


def test_step_indexed_gram_matches_sliced(rng):
    """The scan kernels index the full (T, B, V, B) Gram and (T, V, B, ...)
    coefficients by the block step t themselves; step t of the full arrays
    must equal the same kernel on that step's slice alone."""
    from nextgp_tpu.ops import gibbs_kernels as gk

    T, B, V, K = 3, 8, 4, 3
    gram = jnp.asarray(rng.normal(0, 1, (T, B, V, B)).astype(np.float32))
    r0 = jnp.asarray(rng.normal(0, 1, (V, B)).astype(np.float32))
    head = jnp.asarray(rng.uniform(0, 1, (T, V, B, 8)).astype(np.float32))
    cls = jnp.asarray(rng.uniform(0, 1, (T, V, B, 4, gk.pow2(K))).astype(np.float32))
    for t in range(T):
        ref = gk.r_block_scan(gram[t:t + 1], 0, r0, head[t:t + 1], cls[t:t + 1], K,
                              interpret=True)
        stp = gk.r_block_scan(gram, t, r0, head, cls, K, interpret=True)
        for a, b in zip(ref, stp):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ref = gk.gauss_block_scan(gram[1:2], 0, r0, head[1:2], interpret=True)
    stp = gk.gauss_block_scan(gram, 1, r0, head, interpret=True)
    for a, b in zip(ref, stp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("method", ["BayesPR", "BayesB", "BayesC", "BayesR",
                                    "BayesRCpi", "BayesRCplus", "BayesLV"])
@pytest.mark.parametrize("vsh", [1, 3])
def test_weighted_pallas_matches_pure_jax(rng, method, vsh):
    """Weighted-residual ("D", mme.jl:71-75) models on the kernel route for
    EVERY sampler (the reference supports "D" universally): the BC kernel
    takes the raw Gram as a second stream for the indicator's rrr
    (functions.jl:168); R/RCpi/RCplus/LV precompute weighted coefficients
    into the per-locus streams. Each must match the pure-JAX weighted scan
    from shared streams at V=1 and V>1."""
    spec, _, _ = _spec(rng, method=method)
    import dataclasses
    spec = dataclasses.replace(
        spec, residual=ng.Random(rng.uniform(0.5, 2.0, len(spec.y)), 1.0))
    _, st_jax = _run(spec, n_sweeps=10, vshards=vsh, route="xla")
    _, st_pal = _run(spec, n_sweeps=10, vshards=vsh, **KERNELS)
    np.testing.assert_allclose(
        np.asarray(st_jax.markers[0].beta),
        np.asarray(st_pal.markers[0].beta),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(st_jax.ycorr), np.asarray(st_pal.ycorr), atol=1e-5
    )
    if method in ("BayesB", "BayesC", "BayesR", "BayesRCpi", "BayesRCplus"):
        assert np.array_equal(
            np.asarray(st_jax.markers[0].delta),
            np.asarray(st_pal.markers[0].delta),
        )
