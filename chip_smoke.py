"""Quickest proof that the system runs on one GPU, end to end.

    python chip_smoke.py            # one card: phases 1-6 below
    python chip_smoke.py --four     # four cards: the sharded and multi-chain path only

One process holds the card(s) and makes all its data from --seed. Each
phase prints its own lines; any failure exits non-zero and prints no "ok".

1. Device: what JAX found, the card's name and power limit. Not a GPU: fail.
2. Main path: run_lmem, BayesR with estimated pi, 10,000 x 49,152 int8
   dosages through from_array, vshards="auto", output files written.
3. Packed route: BayesR at 50,000 x 36,864 through from_packed.
4. Kernels against their plain references at real widths (B = 256).
5. Route timings: the end-to-end sweep times that decided each kernel.
6. The `gpu`-marked tests, in this process.

The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# --- tolerances (f32 on the card; references in f64 on the host or f32 XLA)
# ycorr drift: the carried residual against y - Xb - M beta recomputed in
# f64, after every sweep's f32 updates; relative to max |y|.
DRIFT_BOUND = 1e-3
# one sweep of a scan kernel against the plain scan from the same state:
# max |diff| relative to the field's max |value| (f32 summation order).
KERNEL_RTOL = 1e-4
# indicator flips: draws within f32 rounding of their threshold, per locus
FLIP_RATE = 1e-4
# a panel pass against unpack2 and an f64 product, relative to max |ref|
PASS_RTOL = 1e-5
EBV_MIN_CORR = 0.8


def say(phase, **kw):
    print(f"[{phase}] " + json.dumps(kw, default=float), flush=True)


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


# ------------------------------------------------------------------ data


def simulate(n, p, seed, n_causal=200, packed=False, chunk=4096):
    """Genotypes (0..2), a planted sparse signal and y, made on the device
    in column chunks. Returns (int8 host (n, p) or packed host (p, q),
    center (p,), y (n,), beta_true (p,)) as numpy arrays."""
    import jax
    import jax.numpy as jnp

    from nextgp_tpu.ops import pack2
    from nextgp_tpu.utils import HI

    rng = np.random.default_rng(seed)
    beta = np.zeros(p)
    beta[rng.choice(p, n_causal, replace=False)] = rng.normal(0.0, 0.25, n_causal)
    q = pack2.packed_q(n)

    @jax.jit
    def one(key, b):
        g = jax.random.randint(key, (n, b.shape[0]), 0, 3, jnp.int8)
        sig = jnp.matmul(g.astype(jnp.float32), b, precision=HI)
        cen = jnp.mean(g.astype(jnp.float32), axis=0)
        if packed:
            gp = jnp.zeros((4 * q, b.shape[0]), jnp.uint8).at[:n].set(g.astype(jnp.uint8))
            g4 = gp.reshape(4, q, -1)
            g = (g4[0] | (g4[1] << 2) | (g4[2] << 4) | (g4[3] << 6)).T
        return g, sig, cen

    key = jax.random.key(seed)
    parts, sig, cens = [], np.zeros(n), []
    for i0 in range(0, p, chunk):
        g, s, c = one(jax.random.fold_in(key, i0), jnp.asarray(beta[i0:i0 + chunk], jnp.float32))
        parts.append(np.asarray(g))
        sig += np.asarray(s, np.float64)
        cens.append(np.asarray(c, np.float64))
    geno = np.concatenate(parts, axis=0 if packed else 1)
    y = sig - sig.mean() + rng.normal(0.0, 1.0, n)
    return geno, np.concatenate(cens), y, beta


def bayesr():
    import nextgp_tpu as ng

    return ng.BayesR([0.9, 0.05, 0.03, 0.02], [0.0, 1e-4, 1e-3, 1e-2], 1.0, estimatePi=True)


def spec_of(md, y, prior, weights=None):
    import nextgp_tpu as ng

    kw = {"residual": ng.Random(weights, 1.0)} if weights is not None else {}
    return ng.ModelSpec(y=y, fixed=[ng.FixedTerm("int", np.ones(len(y)))],
                        markers=[ng.MarkerTerm("M1", md, prior)], block_size=256, **kw)


def drift(state, y, gv):
    """max |ycorr - (y - b - Mc beta)| / max |y|, with Mc beta (gv) in f64."""
    b = float(np.asarray(state.fixed[0].b, np.float64)[0])
    recon = y - b - gv
    return float(np.max(np.abs(np.asarray(state.ycorr, np.float64) - recon)) / np.max(np.abs(y)))


def ebv_corr(gv_hat, gv_true):
    return float(np.corrcoef(gv_hat, gv_true)[0, 1])


# ------------------------------------------------------------------ phases


def phase_device(want_count):
    import jax

    from nextgp_tpu.diag import card_info

    devs = jax.devices()
    check(devs[0].platform == "gpu", f"JAX found no GPU: {devs}")
    check(len(devs) >= want_count, f"needs {want_count} GPUs, found {len(devs)}")
    card = card_info()
    say("1 device", devices=str(devs), platform=devs[0].platform,
        kind=devs[0].device_kind, count=len(devs))
    print(card, flush=True)
    return devs


def phase_main(n, p, seed, out_root):
    import jax

    import nextgp_tpu as ng
    from nextgp_tpu.engine.sweep import make_chain_runner
    from nextgp_tpu.runtime import run_lmem

    g, center, y, beta_true = simulate(n, p, seed)
    md = ng.from_array(g)
    spec = spec_of(md, y, bayesr())
    t0 = time.perf_counter()
    plan, state = ng.assemble(spec, vshards="auto")
    jax.block_until_ready(state)
    t_asm = time.perf_counter() - t0
    mp = plan.markers[0]
    thin = 100
    runner = make_chain_runner(plan, thin)
    key = jax.random.key(seed)
    t0 = time.perf_counter()
    state, _ = runner(state, key)
    jax.block_until_ready(state)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, _ = runner(state, key)
    jax.block_until_ready(state)
    t_run = time.perf_counter() - t0
    say("2 main", n=n, p=p, route=mp.route, vshards=mp.vshards, packed=mp.packed,
        assemble_s=t_asm, compile_s=t_first - t_run, sweeps_per_s=thin / t_run)
    del state

    out = os.path.join(out_root, "main")
    t0 = time.perf_counter()
    res = run_lmem(spec, n_chain=1500, n_burn=500, n_thin=100, out_folder=out, seed=seed)
    wall = time.perf_counter() - t0
    beta_hat = res.posterior_mean("betaM1")
    gv_true = g.astype(np.float64) @ beta_true
    corr = ebv_corr(ng.genomic_values(md, beta_hat), gv_true)
    beta_now = np.asarray(res.state.markers[0].beta, np.float64)[:p]
    d = drift(res.state, y, ng.genomic_values(md, beta_now))
    say("2 main", entry="run_lmem", sweeps=1500, wall_s=wall,
        sweeps_per_s_incl_compile=res.sweeps_per_sec, ebv_corr=corr,
        ycorr_drift=d, drift_bound=DRIFT_BOUND)
    check(np.isfinite(res.sweeps_per_sec) and res.sweeps_per_sec > 0, "sweeps/s not finite")
    check(corr > EBV_MIN_CORR, f"EBV correlation {corr:.3f} <= {EBV_MIN_CORR}")
    check(d <= DRIFT_BOUND, f"ycorr drift {d:.2e} > {DRIFT_BOUND}")
    for name, width in (("varEOut", 1), ("betaM1Out", p), ("deltaM1Out", p), ("piM1Out", 4)):
        with open(os.path.join(out, name)) as fh:
            head = fh.readline().split()
            rows = sum(1 for _ in fh)
        check(len(head) == width, f"{name}: header has {len(head)} columns, want {width}")
        check(rows == 10, f"{name}: {rows} kept rows, want 10")
    check(open(os.path.join(out, "betaM1Out")).readline().split()[:2] == ["M1", "M2"],
          "betaM1Out header is not the SNP ids")
    say("2 main", output_files="ok", folder=out)


def phase_packed(n, p, seed, sweeps=20):
    import jax

    import nextgp_tpu as ng
    from nextgp_tpu.engine.sweep import make_chain_runner

    pk, center, y, beta_true = simulate(n, p, seed + 1, packed=True)
    md = ng.from_packed(pk, n_ind=n, center=center)
    plan, state = ng.assemble(spec_of(md, y, bayesr()), vshards="auto")
    mp = plan.markers[0]
    runner = make_chain_runner(plan, sweeps)
    key = jax.random.key(seed)
    state, _ = runner(state, key)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state, _ = runner(state, key)
    jax.block_until_ready(state)
    t_run = time.perf_counter() - t0
    beta_now = np.asarray(state.markers[0].beta, np.float64)[:p]
    gv_host = ng.genomic_values(md, beta_now)
    d = drift(state, y, gv_host)
    gv_dev = np.asarray(ng.genomic_values_state(plan, state), np.float64)
    gerr = float(np.max(np.abs(gv_dev - gv_host)) / np.max(np.abs(gv_host)))
    say("3 packed", n=n, p=p, route=mp.route, vshards=mp.vshards, packed=mp.packed,
        sweeps_per_s=sweeps / t_run, ycorr_drift=d, drift_bound=DRIFT_BOUND,
        genomic_values_state_max_rel=gerr, bound=PASS_RTOL)
    check(mp.packed, "from_packed did not give packed storage")
    check(d <= DRIFT_BOUND, f"packed ycorr drift {d:.2e} > {DRIFT_BOUND}")
    check(gerr <= PASS_RTOL, f"genomic_values_state off by {gerr:.2e}")


def with_markers(plan, **kw):
    return dataclasses.replace(
        plan, markers=tuple(dataclasses.replace(m, **kw) for m in plan.markers))


def _rel(a, b, scale=None):
    """max |a - b| relative to `scale` (default: max |b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.max(np.abs(b)) if scale is None else scale
    return float(np.max(np.abs(a - b)) / max(1e-30, scale))


def compare_chains(ma, mb, vshards, block):
    """Compare two marker states sampled from the same state and streams,
    separating indicator flips from value errors.

    A draw within f32 rounding of its threshold may pick another class on
    the two routes; everything downstream of that locus in the chain then
    legitimately differs (ycorr, hence every later block step). Locus
    (t, v, b) depends on all steps before t and on loci b' < b of chain v
    in step t. So: find the earliest step t* with any divergence; the root
    divergences are the first divergent locus of each chain in t*. A root
    that is an indicator flip counts as a flip; value errors are measured
    on the loci upstream of every root (where both routes had the same
    inputs), a root without a flip included."""
    p_pad = ma.beta.shape[0]
    nb = p_pad // block
    T = nb // vshards
    beta_a, beta_b = (np.asarray(m.beta, np.float64) for m in (ma, mb))
    scale = max(1e-30, np.max(np.abs(beta_b)))
    flip = np.asarray(ma.delta) != np.asarray(mb.delta)
    if ma.annot_cat is not None:
        flip |= np.asarray(ma.annot_cat) != np.asarray(mb.annot_cat)
    err = np.abs(beta_a - beta_b) / scale
    # flat locus order is (v, t, b): block g = v*T + t
    flip3 = flip.reshape(vshards, T, block)
    bad3 = (flip | (err > KERNEL_RTOL)).reshape(vshards, T, block)
    upstream = np.ones((vshards, T, block), bool)
    roots = 0
    steps = np.nonzero(bad3.any(axis=(0, 2)))[0]
    if len(steps):
        t = steps[0]
        upstream[:, t + 1:] = False
        for v in np.nonzero(bad3[:, t].any(axis=1))[0]:
            b = np.argmax(bad3[v, t])
            upstream[v, t, b + 1:] = False
            if flip3[v, t, b]:
                upstream[v, t, b] = False
                roots += 1
    up = upstream.reshape(-1)
    return dict(indicator_flips=int(flip.sum()), root_flips=roots,
                upstream_loci=int(up.sum()),
                beta_max_rel=float(err[up].max()) if up.any() else 0.0,
                diverged=bool(len(steps)))


def phase_kernels(n, p, seed):
    """One sweep of each Triton scan from the state the plain route
    reached, against the plain route's sweep (same storage, same passes)."""
    import jax
    import jax.numpy as jnp

    import nextgp_tpu as ng
    from nextgp_tpu.ops import pack2

    g, center, y, _ = simulate(n, p, seed + 2)
    md = ng.from_array(g)
    rng = np.random.default_rng(seed)
    annot = rng.integers(0, 2, (p, 3)) | np.array([1, 0, 0])
    weights = rng.uniform(0.5, 2.0, n)
    cases = {
        "BayesPR (gauss)": (ng.BayesPR(9999, 0.05), None),
        "BayesC (bc)": (ng.BayesC(0.95, 0.05, estimatePi=True), None),
        "BayesC weighted (bc_w)": (ng.BayesC(0.95, 0.05, estimatePi=True), weights),
        "BayesR (r)": (bayesr(), None),
        "BayesRCpi (rcpi)": (ng.BayesRCpi([0.9, 0.05, 0.05], [0.0, 1e-3, 1e-2], 1.0, annot), None),
        "BayesRCplus (rcplus)": (ng.BayesRCplus([0.9, 0.05, 0.05], [0.0, 1e-3, 1e-2], 1.0, annot), None),
    }
    for name, (prior, w) in cases.items():
        for vsh in ("auto", 1):
            plan, state = ng.assemble(spec_of(md, y, prior, w), vshards=vsh)
            check(plan.markers[0].route == "triton", "the GPU route is not Triton")
            plain = with_markers(plan, route="xla")
            sweep_x = jax.jit(ng.make_sweep(plain))
            for i in range(2):
                state = sweep_x(state, jax.random.key(i))
            a = jax.jit(ng.make_sweep(plan))(state, jax.random.key(7))
            b = sweep_x(state, jax.random.key(7))
            mp = plan.markers[0]
            cmp = compare_chains(a.markers[0], b.markers[0], mp.vshards, mp.block)
            # ycorr sums every locus, so it is comparable only without a flip
            ey = None if cmp["diverged"] else _rel(a.ycorr, b.ycorr)
            say("4 kernels", kernel=name, B=mp.block, V=mp.vshards, n=n, p=p,
                precision="f32", tol=KERNEL_RTOL, ycorr_max_rel=ey,
                root_flip_bound=int(FLIP_RATE * p), **cmp)
            check(cmp["root_flips"] <= FLIP_RATE * p,
                  f"{name}: {cmp['root_flips']} indicator flips at their roots")
            check(cmp["beta_max_rel"] <= KERNEL_RTOL and (ey is None or ey <= KERNEL_RTOL),
                  f"{name} V={vsh}: beta {cmp['beta_max_rel']:.2e} / ycorr {ey} > {KERNEL_RTOL}")
            del state, a, b

    # the fused planar passes against unpack2 + an f64 product, at the
    # rows of one V=auto block step
    rows = min(p, plan.markers[0].block * 96)
    pk = jnp.asarray(pack2.pack2_np(g[:, :rows]))
    yv = jnp.asarray(rng.normal(0, 1, n), jnp.float32)
    u = jnp.asarray(rng.normal(0, 1, rows), jnp.float32)
    dense = np.asarray(pack2.unpack2(pk, jnp.float32), np.float64)[:, :n]
    eg = _rel(jax.jit(pack2.gather)(pk, yv), dense @ np.asarray(yv, np.float64))
    es = _rel(jax.jit(pack2.scatter, static_argnums=2)(pk, u, n), np.asarray(u, np.float64) @ dense)
    say("4 kernels", passes="fused planar gather/scatter", rows=rows, n=n, precision="f32",
        tol=PASS_RTOL, gather_max_rel=eg, scatter_max_rel=es)
    check(eg <= PASS_RTOL and es <= PASS_RTOL, "fused panel passes out of tolerance")


def _time(plan, state, k):
    import jax
    from jax import lax

    import nextgp_tpu as ng

    sweep = ng.make_sweep(plan)
    f = jax.jit(lambda st, key: lax.scan(lambda s, _: (sweep(s, key), None), st, None,
                                          length=k)[0])
    key = jax.random.key(0)
    st = f(state, key)
    jax.block_until_ready(st)
    t0 = time.perf_counter()
    st = f(st, key)
    jax.block_until_ready(st)
    return (time.perf_counter() - t0) / k


def phase_routes(n, p, seed):
    """The end-to-end sweep times behind each choice, on this card."""
    import nextgp_tpu as ng
    from nextgp_tpu.diag import card_info

    g, center, y, _ = simulate(n, p, seed + 3)
    md = ng.from_array(g)
    rng = np.random.default_rng(seed)
    annot = rng.integers(0, 2, (p, 3)) | np.array([1, 0, 0])
    card = card_info()
    cases = (("BayesR est-pi", bayesr(), None),
             ("BayesC weighted", ng.BayesC(0.95, 0.05, estimatePi=True), rng.uniform(0.5, 2.0, n)),
             ("BayesRCplus", ng.BayesRCplus([0.9, 0.05, 0.05], [0.0, 1e-3, 1e-2], 1.0, annot), None))
    for name, prior, w in cases:
        spec = spec_of(md, y, prior, w)
        for vsh in ("auto", 1):
            plan, state = ng.assemble(spec, vshards=vsh)
            k = 20 if vsh == "auto" else 4
            t_tr = _time(plan, state, k)
            t_x = _time(with_markers(plan, route="xla"), state, k if vsh == "auto" else 1)
            say("5 routes", model=name, n=n, p=p, V=plan.markers[0].vshards,
                triton_ms=t_tr * 1e3, xla_ms=t_x * 1e3, card=card)
    spec = spec_of(md, y, bayesr())
    plan, state = ng.assemble(spec, vshards="auto")
    t_dot = _time(with_markers(plan, fused_passes=False), state, 20)
    t_fused = _time(plan, state, 20)
    plan8, state8 = ng.assemble(spec, vshards="auto", pack2=False)
    t_int8 = _time(plan8, state8, 20)
    say("5 routes", model="BayesR est-pi", V=plan.markers[0].vshards,
        packed_fused_ms=t_fused * 1e3, packed_dot_ms=t_dot * 1e3, int8_fused_ms=t_int8 * 1e3,
        card=card)


def phase_tests():
    import pytest

    os.environ["NEXTGP_TEST_DEVICE"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
                      os.path.join(HERE, "tests")])
    say("6 tests", pytest_exit=int(rc))
    check(rc == 0, f"gpu-marked tests failed (pytest exit {int(rc)})")


def phase_four(n, p, seed, sweeps=2):
    """Marker sharding across four cards against one card, and four chains."""
    import jax

    import nextgp_tpu as ng
    from nextgp_tpu.parallel import sharded
    from nextgp_tpu.runtime import run_chains

    g, center, y, _ = simulate(n, p, seed)
    spec = spec_of(ng.from_array(g), y, bayesr())
    plan, state = ng.assemble(spec, vshards="auto")
    mp = plan.markers[0]
    check(mp.vshards % 4 == 0, f"V={mp.vshards} is not a multiple of 4")
    keys = jax.random.split(jax.random.key(seed), 1)

    mesh = sharded.make_mesh(1, 4, devices=jax.devices()[:4])
    batched = sharded.distribute(plan, state, mesh, 1)
    shards = batched.markers[0].mt.addressable_shards
    holders = sorted({s.device.id for s in shards})
    quarter = all(s.data.shape[1] * 4 == batched.markers[0].mt.shape[1] for s in shards)
    say("four", mt_shape=batched.markers[0].mt.shape, shard_shapes=[s.data.shape for s in shards],
        devices=holders)
    check(len(holders) == 4 and quarter, "mt is not split across the four cards")

    # sweep by sweep: after a near-threshold flip the two chains differ by
    # more than rounding, so the comparison stops at the first diverged sweep
    four = sharded.make_sharded_sweep(plan, mesh, n_sweeps=1)(batched)
    single = jax.jit(ng.make_sweep(plan))
    out, ref = batched, state
    for sweep in range(1, sweeps + 1):
        out, ref = four(out, keys), single(ref, keys[0])
        mo = out.markers[0]
        m_out = types.SimpleNamespace(beta=mo.beta[0], delta=mo.delta[0], annot_cat=None,
                                      var_beta=mo.var_beta[0], pi_hat=mo.pi_hat[0])
        cmp = compare_chains(m_out, ref.markers[0], mp.vshards, mp.block)
        # relative to each field's own scale; the intercept is drawn near 0
        # from sum(ycorr), so it is measured on the residual's scale
        errs = {name: _rel(a, b, scale) for name, a, b, scale in (
            ("ycorr", out.ycorr[0], ref.ycorr, None),
            ("var_e", out.e.var_e[0], ref.e.var_e, None),
            ("b", out.fixed[0].b[0], ref.fixed[0].b, np.max(np.abs(y))),
            ("beta", m_out.beta, ref.markers[0].beta, None),
            ("var_beta", m_out.var_beta, ref.markers[0].var_beta, None),
            ("pi_hat", m_out.pi_hat, ref.markers[0].pi_hat, None))}
        same_index = int(np.asarray(out.sweep_index)[0]) == int(np.asarray(ref.sweep_index))
        say("four", chains=1, shards=4, V=mp.vshards, sweep=sweep, precision="f32",
            tol=KERNEL_RTOL, max_rel=errs, **cmp)
        check(same_index and cmp["root_flips"] <= FLIP_RATE * p,
              f"sharded chain diverged ({cmp['root_flips']} root flips)")
        if cmp["diverged"]:  # a near-threshold flip: compare upstream of it only
            check(cmp["beta_max_rel"] <= KERNEL_RTOL, f"sharded != single card: {cmp}")
            break
        check(all(e <= KERNEL_RTOL for e in errs.values()), f"sharded != single card: {errs}")

    res = run_chains(spec, n_chains=4, n_chain=400, n_burn=200, n_thin=10, n_shards=1,
                     seed=seed, track=("varE", "piM1"))
    rhat = {k: np.asarray(v).round(4).tolist() for k, v in res["rhat"].items()}
    say("four", chains=4, shards=1, kept_per_chain=20, split_rhat=rhat)
    check(all(np.all(np.isfinite(v)) for v in res["rhat"].values()), "R-hat not finite")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase (sharded chain and four chains)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    devs = phase_device(4 if args.four else 1)
    from nextgp_tpu import backend

    backend.compile_cache()
    if args.four:
        phase_four(10_000, 49_152, args.seed)
    else:
        out_root = os.path.join(HERE, "outMCMC", "chip_smoke")
        phase_main(10_000, 49_152, args.seed, out_root)
        phase_packed(50_000, 36_864, args.seed)
        phase_kernels(2_000, 49_152, args.seed)
        phase_routes(10_000, 49_152, args.seed)
        phase_tests()
    print(json.dumps({"ok": True, "device": {"platform": devs[0].platform,
                                             "kind": devs[0].device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
