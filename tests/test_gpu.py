"""Tests that need the card: the Triton kernels compiled for the GPU (no
interpreter) against the plain route. They skip elsewhere; chip_smoke.py
runs them on the card in its own process."""
import dataclasses

import jax
import numpy as np
import pytest

import nextgp_tpu as ng

pytestmark = pytest.mark.gpu


def _spec(rng, prior, n=300, p=2048, weighted=False):
    g = rng.integers(0, 3, (n, p)).astype(np.int8)
    bt = np.where(rng.uniform(size=p) < 0.05, rng.normal(0, 0.2, p), 0.0)
    y = (g - g.mean(0)) @ bt + rng.normal(0, 1, n)
    kw = {"residual": ng.Random(rng.uniform(0.5, 2.0, n), 1.0)} if weighted else {}
    return ng.ModelSpec(y=y, fixed=[ng.FixedTerm("int", np.ones(n))],
                        markers=[ng.MarkerTerm("M", ng.from_array(g), prior)],
                        block_size=128, **kw)


def _priors(p):
    annot = np.random.default_rng(3).integers(0, 2, (p, 3)) | np.array([1, 0, 0])
    return {
        "BayesPR": (ng.BayesPR(9999, 0.05), False),
        "BayesCw": (ng.BayesC(0.9, 0.05, estimatePi=True), True),
        "BayesB": (ng.BayesB(0.9, 0.05), False),
        "BayesR": (ng.BayesR([0.9, 0.05, 0.03, 0.02], [0.0, 1e-4, 1e-3, 1e-2], 1.0,
                             estimatePi=True), False),
        "BayesRCpi": (ng.BayesRCpi([0.9, 0.05, 0.05], [0.0, 1e-3, 1e-2], 1.0, annot), False),
        "BayesRCplus": (ng.BayesRCplus([0.9, 0.05, 0.05], [0.0, 1e-3, 1e-2], 1.0, annot), False),
    }


@pytest.mark.parametrize("vsh", [4])
@pytest.mark.parametrize("method", list(_priors(2048)))
def test_triton_scan_matches_xla_on_gpu(gpu, rng, method, vsh):
    """One sweep of each compiled scan kernel from the state the plain
    route reached, against the plain route's sweep. f32 on both sides:
    beta to 1e-4 of its scale; indicators may flip only for draws within
    rounding of their threshold (at most 1 in 2048 loci)."""
    prior, weighted = _priors(2048)[method]
    plan, state = ng.assemble(_spec(rng, prior, weighted=weighted), vshards=vsh)
    mp = plan.markers[0]
    assert mp.route == "triton" and not mp.interpret
    xla = dataclasses.replace(plan, markers=(dataclasses.replace(mp, route="xla"),))
    sweep_x = jax.jit(ng.make_sweep(xla))
    for _ in range(3):
        state = sweep_x(state, jax.random.key(1))
    a = jax.jit(ng.make_sweep(plan))(state, jax.random.key(2))
    b = sweep_x(state, jax.random.key(2))
    ba, bb = np.asarray(a.markers[0].beta), np.asarray(b.markers[0].beta)
    flips = int(np.sum(np.asarray(a.markers[0].delta) != np.asarray(b.markers[0].delta)))
    assert flips <= 1
    if flips == 0:
        np.testing.assert_allclose(ba, bb, atol=1e-4 * max(1.0, np.abs(bb).max()))
