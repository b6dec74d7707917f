"""Statistical correctness (SURVEY.md §4.3): conjugate cases where the Gibbs
posterior mean must match the Henderson MME solution, plus CG itself."""
import numpy as np
import jax
import jax.numpy as jnp

import nextgp_tpu as ng
from nextgp_tpu.ops.cg import cg_solve, solve_mme


def test_cg_matches_direct_solve(rng):
    n = 40
    a = rng.normal(size=(n, n))
    A = a @ a.T + n * np.eye(n)
    b = rng.normal(size=n)
    x, it, res = cg_solve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, b), rtol=1e-6, atol=1e-8)


def test_ridge_gibbs_posterior_mean_matches_mme(rng):
    """Fixed variances (ridge, known varE): the BayesPR full conditional is
    Gaussian and the chain's posterior mean over beta must converge to the
    MME solution (X'X/ve + I/vb)^-1 X'y."""
    n, p = 200, 40
    g = rng.integers(0, 3, (n, p)).astype(float)
    gc = g - g.mean(0)
    beta_true = rng.normal(0, 0.3, p)
    y = gc @ beta_true + rng.normal(0, 1.0, n)
    vb, ve = 0.1, 1.0

    spec = ng.ModelSpec(
        y=y,
        markers=[ng.MarkerTerm("M1", ng.from_array(g), ng.BayesPR(9999, vb))],
        block_size=16,
    )
    plan, state = ng.assemble(spec)

    # direct MME solution at the fixed variances
    A = gc.T @ gc / ve + np.eye(p) / vb
    direct = np.linalg.solve(A, gc.T @ y / ve)

    # CG path
    sol, it, res = solve_mme(plan, state, jnp.asarray(ve))
    np.testing.assert_allclose(np.asarray(sol["beta:M1"])[:p], direct, rtol=1e-5, atol=1e-7)

    # Gibbs path with variances frozen: run the marker stage only, holding
    # varE and varBeta fixed by resetting them each sweep
    from nextgp_tpu.engine.samplers.markers import sample_marker_set
    from nextgp_tpu.engine import rng as RNG
    from nextgp_tpu.utils import replace

    @jax.jit
    def fixed_var_sweep(ms, ycorr, key, sweep_idx):
        skey = RNG.sweep_key(key, sweep_idx)
        k = RNG.stage_key(skey, RNG.STAGE_MARKER, 0)
        ms, ycorr = sample_marker_set(k, ms, plan.markers[0], ycorr, jnp.asarray(ve), None)
        ms = replace(ms, var_beta=jnp.full_like(ms.var_beta, vb))  # freeze
        return ms, ycorr

    ms = state.markers[0]
    ycorr = state.ycorr
    key = jax.random.key(0)
    tot = np.zeros(p)
    n_keep = 0
    for i in range(600):
        ms, ycorr = fixed_var_sweep(ms, ycorr, key, jnp.asarray(i))
        if i >= 100:
            tot += np.asarray(ms.beta[:p])
            n_keep += 1
    post_mean = tot / n_keep
    # MC error ~ posterior sd / sqrt(ESS); generous tolerance
    err = np.abs(post_mean - direct)
    sd = np.sqrt(np.diag(np.linalg.inv(A)))
    assert np.all(err < 5 * sd / np.sqrt(50) + 0.02), (err / sd).max()
    assert np.corrcoef(post_mean, direct)[0, 1] > 0.99


def test_pblup_posterior_mean_matches_mme(rng):
    """Pedigree BLUP: u posterior mean vs Henderson solution with A-inverse."""
    from nextgp_tpu.data.pedigree import a_inverse, build_pedigree

    ids = [f"i{k}" for k in range(8)]
    sires = [None, None, "i0", "i0", "i2", "i2", "i4", None]
    dams = [None, None, "i1", "i1", "i3", "i3", "i5", None]
    ped = build_pedigree(ids, sires, dams)
    ainv = a_inverse(ped)
    n_rec = 40
    who = rng.integers(0, 8, n_rec)
    z = (who[:, None] == np.arange(8)[None, :]).astype(float)
    u_true = rng.normal(0, 0.7, 8)
    y = 2.0 + z @ u_true + rng.normal(0, 0.5, n_rec)
    vu, ve = 0.5, 0.25

    x = np.ones((n_rec, 1))
    # Henderson MME
    C = np.block([
        [x.T @ x / ve, x.T @ z / ve],
        [z.T @ x / ve, z.T @ z / ve + ainv / vu],
    ])
    r = np.concatenate([x.T @ y / ve, z.T @ y / ve])
    direct = np.linalg.solve(C, r)

    spec = ng.ModelSpec(
        y=y,
        fixed=[ng.FixedTerm("int", np.ones(n_rec))],
        random=[ng.RandomTerm("ID", z, prior=ng.Random("A", vu), ivstr=ainv)],
    )
    plan, state = ng.assemble(spec)

    from nextgp_tpu.engine.samplers.fixed import sample_fixed_block
    from nextgp_tpu.engine.samplers.random_effects import sample_random_uni
    from nextgp_tpu.engine import rng as RNG
    from nextgp_tpu.utils import replace

    @jax.jit
    def step(fs, rs, ycorr, key, i):
        skey = RNG.sweep_key(key, i)
        b, ycorr = sample_fixed_block(
            RNG.stage_key(skey, RNG.STAGE_FIXED, 0), fs, ycorr, jnp.asarray(ve), True)
        fs = replace(fs, b=b)
        u, _, ycorr = sample_random_uni(
            RNG.stage_key(skey, RNG.STAGE_RANDOM, 0), rs, ycorr, jnp.asarray(ve), plan.random[0].df)
        rs = replace(rs, u=u, var_u=jnp.asarray(vu))  # freeze variance
        return fs, rs, ycorr

    fs, rs, ycorr = state.fixed[0], state.random[0], state.ycorr
    key = jax.random.key(1)
    tot = np.zeros(9)
    cnt = 0
    for i in range(800):
        fs, rs, ycorr = step(fs, rs, ycorr, key, jnp.asarray(i))
        if i >= 200:
            tot += np.concatenate([np.asarray(fs.b), np.asarray(rs.u)])
            cnt += 1
    post = tot / cnt
    np.testing.assert_allclose(post, direct, atol=0.15)
    assert np.corrcoef(post[1:], direct[1:])[0, 1] > 0.95


def test_fixed_effects_match_ols(rng):
    """The reference's Example.md cross-check (docs/src/Example/Example.md:
    135-163): with flat-prior fixed effects only, posterior means of b match
    the lm()/OLS estimates."""
    import jax

    import nextgp_tpu as ng

    n = 120
    x1 = rng.normal(0, 1, n)
    f = rng.integers(0, 3, n)
    X = np.column_stack([np.ones(n), x1, (f == 1).astype(float), (f == 2).astype(float)])
    b_true = np.array([2.0, 0.7, -1.0, 0.5])
    y = X @ b_true + rng.normal(0, 1, n)
    ols = np.linalg.lstsq(X, y, rcond=None)[0]

    spec = ng.ModelSpec(
        y=y,
        fixed=[
            ng.FixedTerm("int", np.ones(n)),
            ng.FixedTerm("x1", x1),
            ng.FixedTerm("f", X[:, 2:4]),
        ],
        blocks=[("int", "x1", "f")],
    )
    plan, state = ng.assemble(spec)
    sweep = jax.jit(ng.make_sweep(plan))
    key = jax.random.key(2)
    bsum = np.zeros(4)
    cnt = 0
    for i in range(800):
        state = sweep(state, key)
        if i >= 200:
            bsum += np.asarray(state.fixed[0].b)
            cnt += 1
    bhat = bsum / cnt
    np.testing.assert_allclose(bhat, ols, atol=0.12)


def test_solve_mme_packed_vshard_storage(rng):
    """solve_mme must normalize any storage layout (2-bit packed bytes,
    vshard t-major rows) back to global-order dosages — treating either
    raw layout as dosages solves a garbage system."""
    import nextgp_tpu as ng

    n, p = 60, 48
    g = rng.integers(0, 3, (n, p)).astype(float)
    y = 1.0 + (g - g.mean(0)) @ rng.normal(0, 0.2, p) + rng.normal(0, 1, n)
    spec = ng.ModelSpec(
        y=y,
        fixed=[ng.FixedTerm("int", np.ones(n))],
        markers=[ng.MarkerTerm("M", ng.from_array(g), ng.BayesPR(9999, 0.05))],
        block_size=8,
    )
    ve = 1.0
    sols = {}
    kern = {"route": "triton", "interpret": True}
    for kw in ({}, {"pack2": True, **kern}, {"pack2": True, "vshards": 3, **kern}):
        plan, state = ng.assemble(spec, **kw)
        sol, it, res = solve_mme(plan, state, jnp.asarray(ve))
        sols[tuple(sorted(kw))] = np.asarray(sol["beta:M"])[:p]
    base = sols[()]
    for k, s in sols.items():
        # marker betas come back in global locus order whatever the storage
        np.testing.assert_allclose(s, base, atol=1e-4)
