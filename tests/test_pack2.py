"""2-bit planar-packed genotype storage (ops/pack2.py, assemble(pack2=True)).

Packing is lossless for 0..3 dosages, so with the dot-form panel passes
(the CPU route) the packed sweep must reproduce the unpacked chain
BIT-FOR-BIT — every method, weighted residuals, vshards, and the
device-sharded schedule included. The fused planar passes of the GPU route
are checked against `unpack2` here and on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nextgp_tpu as ng
from nextgp_tpu.ops import pack2


def test_pack_roundtrip(rng):
    for n in (8, 100, 512, 1000):
        g = rng.integers(0, 3, (n, 24), dtype=np.int8)
        pk = pack2.pack2_np(g)
        q = pack2.packed_q(n)
        assert pk.shape == (24, q) and pk.dtype == np.uint8
        up = np.asarray(pack2.unpack2(jnp.asarray(pk), jnp.float64))
        assert np.array_equal(up[:, :n], g.T)
        assert (up[:, n:] == 0).all()
        pk_dev = np.asarray(pack2.pack2_jnp(jnp.asarray(g)))
        assert np.array_equal(pk_dev, pk)


@pytest.mark.parametrize("n,R", [(600, 64), (601, 48), (7, 8), (512, 24), (1001, 5)])
def test_planar_passes_match_unpack(rng, n, R):
    """pack2.gather/scatter (the fused planar passes) == the dot over the
    unpacked rows, for odd n, n below and at a lane multiple, and padded
    individuals (which must contribute nothing)."""
    g = rng.integers(0, 3, (n, R), dtype=np.int8)
    pk = jnp.asarray(pack2.pack2_np(g))
    y = jnp.asarray(rng.normal(0, 1, n))
    u = jnp.asarray(rng.normal(0, 1, R))
    dense = g.T.astype(np.float64)
    np.testing.assert_allclose(np.asarray(pack2.gather(pk, y)), dense @ np.asarray(y),
                               rtol=1e-12, atol=1e-12)
    d = np.asarray(pack2.scatter(pk, u, n))
    assert d.shape == (n,)
    np.testing.assert_allclose(d, np.asarray(u) @ dense, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("vsh", [1, 3])
@pytest.mark.parametrize("packed", [True, False])
def test_fused_passes_sweep_matches_dot(rng, vsh, packed):
    """The sweep with fused passes (the GPU form) samples the dot-form chain
    up to summation order, in the plain and the vshard storage layout."""
    import dataclasses

    spec = _spec(rng, "BayesR")
    plan, state = ng.assemble(spec, vshards=vsh, pack2=packed)
    assert not plan.markers[0].fused_passes
    fused = dataclasses.replace(
        plan, markers=(dataclasses.replace(plan.markers[0], fused_passes=True),))
    outs = []
    for pl_ in (plan, fused):
        sweep = jax.jit(ng.make_sweep(pl_))
        st = state
        for _ in range(5):
            st = sweep(st, jax.random.key(9))
        outs.append(st)
    np.testing.assert_allclose(np.asarray(outs[0].ycorr), np.asarray(outs[1].ycorr),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(outs[0].markers[0].beta),
                               np.asarray(outs[1].markers[0].beta), atol=1e-9)


def _spec(rng, method, n=80, p=96, weighted=False):
    g = rng.integers(0, 3, (n, p)).astype(float)
    gc = g - g.mean(0)
    bt = np.zeros(p)
    bt[rng.choice(p, 10, replace=False)] = rng.normal(0, 0.4, 10)
    y = 1.0 + gc @ bt + rng.normal(0, 1, n)
    annot = rng.integers(0, 2, (p, 2)) | np.array([1, 0])
    priors = {
        "BayesPR": ng.BayesPR(9999, 0.05),
        "BayesB": ng.BayesB(0.1, 0.05, estimatePi=True),
        "BayesC": ng.BayesC(0.1, 0.05, estimatePi=True),
        "BayesR": ng.BayesR([0.8, 0.1, 0.1], [0.0, 0.01, 0.1], 1.0, estimatePi=True),
        "BayesRCpi": ng.BayesRCpi([0.8, 0.1, 0.1], [0.0, 0.01, 0.1], 1.0, annot),
        "BayesRCplus": ng.BayesRCplus([0.8, 0.1, 0.1], [0.0, 0.01, 0.1], 1.0, annot),
        "BayesLV": ng.BayesLV(0.05, rng.normal(0, 1, (p, 2)), 0.1),
    }
    kw = {}
    if weighted:
        kw["residual"] = ng.Random(rng.uniform(0.5, 2.0, n), 1.0)
    return ng.ModelSpec(
        y=y,
        fixed=[ng.FixedTerm("int", np.ones(n))],
        markers=[ng.MarkerTerm("M", ng.from_array(g), priors[method])],
        block_size=16,
        **kw,
    )


def _run(spec, n_sweeps=10, **kw):
    plan, state = ng.assemble(spec, **kw)
    sweep = jax.jit(ng.make_sweep(plan))
    key = jax.random.key(9)
    for _ in range(n_sweeps):
        state = sweep(state, key)
    return plan, state


@pytest.mark.parametrize(
    "method",
    ["BayesPR", "BayesB", "BayesC", "BayesR", "BayesRCpi", "BayesRCplus", "BayesLV"],
)
def test_packed_sweep_bit_identical(rng, method):
    spec = _spec(rng, method)
    plan_u, st_u = _run(spec, pack2=False)
    plan_p, st_p = _run(spec, pack2=True)
    assert not plan_u.markers[0].packed and plan_p.markers[0].packed
    assert st_p.markers[0].mt.dtype == jnp.uint8
    assert np.array_equal(np.asarray(st_u.markers[0].beta), np.asarray(st_p.markers[0].beta))
    assert np.array_equal(np.asarray(st_u.ycorr), np.asarray(st_p.ycorr))
    assert np.array_equal(np.asarray(st_u.markers[0].delta), np.asarray(st_p.markers[0].delta))
    assert np.array_equal(
        np.asarray(st_u.markers[0].var_beta), np.asarray(st_p.markers[0].var_beta)
    )


@pytest.mark.parametrize("method", ["BayesB", "BayesC"])
def test_packed_weighted_bit_identical(rng, method):
    spec = _spec(rng, method, weighted=True)
    _, st_u = _run(spec, pack2=False)
    _, st_p = _run(spec, pack2=True)
    assert np.array_equal(np.asarray(st_u.markers[0].beta), np.asarray(st_p.markers[0].beta))
    assert np.array_equal(np.asarray(st_u.ycorr), np.asarray(st_p.ycorr))


def test_packed_vshards_bit_identical(rng):
    spec = _spec(rng, "BayesR")
    _, st_u = _run(spec, vshards=3, pack2=False)
    _, st_p = _run(spec, vshards=3, pack2=True)
    assert st_p.markers[0].mt.ndim == 4 and st_p.markers[0].mt.dtype == jnp.uint8
    assert np.array_equal(np.asarray(st_u.markers[0].beta), np.asarray(st_p.markers[0].beta))
    assert np.array_equal(np.asarray(st_u.ycorr), np.asarray(st_p.ycorr))


def test_packed_sharded_bit_identical(rng):
    from nextgp_tpu.parallel.sharded import distribute, make_mesh, make_sharded_sweep

    spec = _spec(rng, "BayesR")
    outs = []
    for pk in (False, True):
        plan, state = ng.assemble(spec, pack2=pk)
        mesh = make_mesh(n_chains=1, n_shards=2, devices=jax.devices()[:2])
        batched = distribute(plan, state, mesh, n_chains=1)
        step = make_sharded_sweep(plan, mesh, n_sweeps=5)(batched)
        out = step(batched, jax.random.split(jax.random.key(3), 1))
        outs.append(
            (np.asarray(out.markers[0].beta[0]), np.asarray(out.ycorr[0]))
        )
    assert np.array_equal(outs[0][0], outs[1][0])
    assert np.array_equal(outs[0][1], outs[1][1])


def test_pack_eligibility(rng):
    n, p = 40, 32
    gf = rng.normal(1.0, 0.5, (n, p))  # fractional dosages
    y = rng.normal(0, 1, n)
    spec = ng.ModelSpec(
        y=y,
        fixed=[ng.FixedTerm("int", np.ones(n))],
        markers=[ng.MarkerTerm("M", ng.from_float_array(gf), ng.BayesPR(9999, 0.05))],
        block_size=16,
    )
    plan, _ = ng.assemble(spec)  # auto: silently unpacked
    assert not plan.markers[0].packed
    with pytest.raises(ValueError, match="pack2"):
        ng.assemble(spec, pack2=True)


def test_from_packed_matches_from_array(rng):
    """from_packed (pre-packed rows, the beyond-HBM ingestion path) must
    sample the identical chain as from_array + pack2=True, including with
    virtual shards and SNP-axis padding (p not a multiple of block)."""
    n, p = 70, 88  # p pads to 96 at block 16
    g = rng.integers(0, 3, (n, p), dtype=np.int8)
    y = 1.0 + (g - g.mean(0)) @ rng.normal(0, 0.2, p) + rng.normal(0, 1, n)
    pk = pack2.pack2_np(g)
    center = g.astype(np.float64).mean(0)
    prior = ng.BayesR([0.8, 0.1, 0.1], [0.0, 0.01, 0.1], 1.0, estimatePi=True)

    def spec(md):
        return ng.ModelSpec(
            y=y,
            fixed=[ng.FixedTerm("int", np.ones(n))],
            markers=[ng.MarkerTerm("M", md, prior)],
            block_size=16,
        )

    for vsh in (1, 3):
        _, st_a = _run(spec(ng.from_array(g.astype(float))), pack2=True, vshards=vsh)
        md = ng.from_packed(pk, n_ind=n, center=center)
        assert md.n_ind == n and md.n_snp == p
        plan_p, st_p = _run(spec(md), vshards=vsh)
        assert plan_p.markers[0].packed
        assert np.array_equal(np.asarray(st_a.markers[0].beta), np.asarray(st_p.markers[0].beta))
        assert np.array_equal(np.asarray(st_a.ycorr), np.asarray(st_p.ycorr))

    # centered() unpacks correctly; pack2=False on packed input is an error
    md = ng.from_packed(pk, n_ind=n, center=center)
    np.testing.assert_allclose(md.centered(), g.astype(np.float64) - center[None, :])
    with pytest.raises(ValueError, match="packed"):
        ng.assemble(spec(md), pack2=False)


def test_run_lmem_with_packed_markers(rng, tmp_path):
    """Full runtime path (writer, summaries, EBV bookkeeping) over
    pre-packed marker data."""
    from nextgp_tpu.runtime import run_lmem

    n, p = 60, 48
    g = rng.integers(0, 3, (n, p), dtype=np.int8)
    y = 1.0 + (g - g.mean(0)) @ rng.normal(0, 0.3, p) + rng.normal(0, 1, n)
    md = ng.from_packed(pack2.pack2_np(g), n_ind=n, center=g.astype(float).mean(0))
    spec = ng.ModelSpec(
        y=y,
        fixed=[ng.FixedTerm("int", np.ones(n))],
        markers=[ng.MarkerTerm("M", md, ng.BayesC(0.2, 0.05, estimatePi=True))],
        block_size=16,
    )
    res = run_lmem(spec, n_chain=60, n_burn=20, n_thin=4,
                   out_folder=str(tmp_path / "out"))
    beta = res.posterior_mean("betaM")
    assert beta.shape == (p,) and np.isfinite(beta).all()
    assert (tmp_path / "out" / "betaMOut").exists()


def test_genomic_values_packed_matches_dense(rng):
    """predict.genomic_values contracts on the packed bytes directly and
    must equal the dense centered M @ beta; predict() centers new
    individuals with the TRAINING allele means."""
    n, p = 150, 300
    g = rng.integers(0, 3, (n, p), dtype=np.int8)
    center = g.astype(float).mean(0)
    beta = rng.normal(0, 0.1, p)
    md_dense = ng.from_array(g)
    md_packed = ng.from_packed(pack2.pack2_np(g), n_ind=n, center=center)
    ref = (g - center[None, :]) @ beta
    np.testing.assert_allclose(ng.genomic_values(md_dense, beta), ref, atol=1e-9)
    np.testing.assert_allclose(
        ng.genomic_values(md_packed, beta, chunk=64), ref, atol=1e-9)
    g_new = rng.integers(0, 3, (7, p))
    np.testing.assert_allclose(
        ng.predict(md_dense, beta, g_new), (g_new - center[None, :]) @ beta,
        atol=1e-9)
    with pytest.raises(ValueError, match="loci"):
        ng.genomic_values(md_dense, beta[:-1])
    with pytest.raises(ValueError, match="must be"):
        ng.predict(md_dense, beta, g_new[:, :-1])


@pytest.mark.parametrize("packed,vsh", [(True, 1), (True, 3), (False, 1), (False, 3)])
def test_genomic_values_state_matches_dense(rng, packed, vsh):
    """genomic_values_state serves EBVs straight off the assembled device
    storage (packed or int8, plain or vshard layout, dot or fused pass) and
    must equal the dense centered Mc @ beta for both the live draw and an
    explicit beta."""
    n, p = 90, 96
    g = rng.integers(0, 3, (n, p)).astype(float)
    center = g.mean(0)
    y = rng.normal(0, 1, n)
    spec = ng.ModelSpec(
        y=y,
        fixed=[ng.FixedTerm("int", np.ones(n))],
        markers=[ng.MarkerTerm("M", ng.from_array(g), ng.BayesPR(9999, 0.05))],
        block_size=16,
    )
    import dataclasses

    plan, state = ng.assemble(spec, pack2=packed, vshards=vsh)
    sweep = jax.jit(ng.make_sweep(plan))
    for _ in range(3):
        state = sweep(state, jax.random.key(2))
    beta_live = np.asarray(state.markers[0].beta[: p])
    ref = (g - center[None, :]) @ beta_live
    bext = rng.normal(0, 0.1, p)
    fused = dataclasses.replace(
        plan, markers=(dataclasses.replace(plan.markers[0], fused_passes=True),))
    for pl_ in (plan, fused):
        got = np.asarray(ng.genomic_values_state(pl_, state))
        np.testing.assert_allclose(got, ref, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(ng.genomic_values_state(pl_, state, beta=bext)),
            (g - center[None, :]) @ bext, atol=1e-5)


def test_corr_markers_packed_bit_identical(rng):
    """Correlated marker sets store 2-bit packed when dosages allow
    (plan.py:_build_corr_marker; VERDICT r4 weak #6): the packed chain must
    equal the unpacked float chain, sequential and V-wide. The unpack is
    exact (same values), but XLA fuses the unpack+einsum differently from
    the dense einsum, so the n-axis reduction order differs — last-bit f64
    round-off only (measured 1e-16/sweep), gated at 1e-12 over 5 sweeps."""
    from nextgp_tpu.api.spec import CorrMarkerTerm

    n, p, block = 52, 32, 8
    g1 = rng.integers(0, 3, (n, p), dtype=np.int8)
    g2 = rng.integers(0, 3, (n, p), dtype=np.int8)
    y = (1.0 + (g1 - g1.mean(0)) @ rng.normal(0, 0.15, p)
         + rng.normal(0, 1, n))
    v = np.array([[0.02, 0.005], [0.005, 0.015]])

    def chain(eligible, vsh):
        mk = (ng.from_array if eligible else
              (lambda g: ng.from_float_array(g.astype(np.float64))))
        spec = ng.ModelSpec(
            y=y,
            fixed=[ng.FixedTerm("int", np.ones(n))],
            corr_markers=[CorrMarkerTerm(
                ("M1", "M2"), (mk(g1), mk(g2)), ng.BayesPR(9999, v))],
            block_size=block,
        )
        plan, state = ng.assemble(spec, vshards=vsh)
        assert (state.corr_markers[0].mt.dtype == jnp.uint8) == eligible
        sweep = jax.jit(ng.make_sweep(plan))
        key = jax.random.key(4)
        for _ in range(5):
            state = sweep(state, key)
        return np.asarray(state.corr_markers[0].beta), np.asarray(state.ycorr)

    for vsh in (1, 2):
        b_pk, y_pk = chain(True, vsh)
        b_f, y_f = chain(False, vsh)
        np.testing.assert_allclose(b_pk, b_f, rtol=0, atol=1e-12)
        np.testing.assert_allclose(y_pk, y_f, rtol=0, atol=1e-12)


def test_genomic_values_state_f64_precision(rng):
    """On x64 runs genomic_values_state computes in the engine dtype
    (ADVICE r4): an f32 compute would lose the tiny beta components this
    fixture plants below f32 resolution of the large ones."""
    n, p = 40, 32
    g = rng.integers(0, 3, (n, p), dtype=np.int8)
    y = rng.normal(0, 1, n)
    spec = ng.ModelSpec(
        y=y,
        fixed=[ng.FixedTerm("int", np.ones(n))],
        markers=[ng.MarkerTerm("M", ng.from_array(g), ng.BayesPR(9999, 0.05))],
        block_size=8,
    )
    plan, state = ng.assemble(spec, pack2=False)  # packed path is f32 by design
    beta = np.zeros(p)
    beta[0] = 1.0
    beta[1] = 1e-9  # below f32 resolution relative to beta[0]'s contribution
    got = np.asarray(ng.genomic_values_state(plan, state, beta=beta))
    gc = g.astype(np.float64) - g.astype(np.float64).mean(0)
    want = gc @ beta
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_corr_markers_reject_prepacked_input(rng):
    """Pre-packed MarkerData in a CorrMarkerTerm errors clearly instead of
    failing with a shape mismatch deep in assembly."""
    from nextgp_tpu.api.spec import CorrMarkerTerm

    n, p = 20, 16
    g = rng.integers(0, 3, (n, p), dtype=np.int8)
    md_pk = ng.from_packed(pack2.pack2_np(g), n_ind=n,
                           center=g.astype(np.float64).mean(0))
    spec = ng.ModelSpec(
        y=rng.normal(0, 1, n),
        fixed=[ng.FixedTerm("int", np.ones(n))],
        corr_markers=[CorrMarkerTerm(
            ("A", "B"), (md_pk, ng.from_array(g)),
            ng.BayesPR(9999, np.eye(2) * 0.02))],
        block_size=8,
    )
    with pytest.raises(ValueError, match="pre-packed"):
        ng.assemble(spec)
