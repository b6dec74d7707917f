"""Per-method sweep timing at one shape: all Bayesian-alphabet samplers.

Measures every method under the production schedule in one process, so
the annotation methods (RCpi/RCplus) can be compared with BayesR.

Run: python scripts/bench_methods.py   (BM_N/BM_P/BM_V/BM_SWEEPS env)
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

import nextgp_tpu as ng
from nextgp_tpu.data.ingest import from_device_array


def main():
    n = int(os.environ.get("BM_N", 10000))
    p = int(os.environ.get("BM_P", 49152))
    v = int(os.environ.get("BM_V", 96))
    n_sweeps = int(os.environ.get("BM_SWEEPS", 30))

    @jax.jit
    def simulate(key):
        kg, ke = jax.random.split(key)
        g = jax.random.randint(kg, (n, p), 0, 3, jnp.int8)
        y = jax.random.normal(ke, (n,))
        return g, y

    g_dev, y_dev = simulate(jax.random.key(0))
    y = np.asarray(jax.device_get(y_dev), np.float64)
    rng = np.random.default_rng(3)
    annot = (rng.integers(0, 2, (p, 3)) | np.array([1, 0, 0])).astype(np.int8)
    lvcov = rng.normal(0, 1, (p, 3))

    priors = {
        "BayesPR": ng.BayesPR(9999, 0.05),
        "BayesB": ng.BayesB(0.95, 0.05, estimatePi=True),
        "BayesC": ng.BayesC(0.95, 0.05, estimatePi=True),
        "BayesR": ng.BayesR([0.9, 0.05, 0.03, 0.02], [0.0, 1e-4, 1e-3, 1e-2], 1.0,
                            estimatePi=True),
        "BayesRCpi": ng.BayesRCpi([0.9, 0.05, 0.05], [0.0, 1e-3, 1e-2], 1.0, annot,
                                  estimatePi=True),
        "BayesRCplus": ng.BayesRCplus([0.9, 0.05, 0.05], [0.0, 1e-3, 1e-2], 1.0, annot),
        "BayesLV": ng.BayesLV(0.01, lvcov, 0.01),
    }
    # weighted-residual ("D") rows: the same samplers with heteroscedastic
    # weights — exercises the two-Gram weighted kernel path (VERDICT r3 #5)
    weights = rng.uniform(0.5, 2.0, n)
    cases = {name: (prior, None) for name, prior in priors.items()}
    for name in ("BayesC", "BayesPR", "BayesR", "BayesLV"):
        cases[f"{name}+D"] = (priors[name], ng.Random(weights, 1.0))
    # correlated two-set row (packed storage + V-wide schedule; the
    # per-locus nT x nT inv/cholesky chain is latency-bound, so p is
    # reduced — the row documents ms/locus, not a like-for-like shape)
    p_corr = int(os.environ.get("BM_P_CORR", 4096))
    cases["CorrPR(2set)"] = ("corr", None)

    only = os.environ.get("BM_ONLY")
    base = None
    for name, (prior, residual) in cases.items():
        if only and only not in name:
            continue
        if prior == "corr":
            from nextgp_tpu.api.spec import CorrMarkerTerm

            rng_c = np.random.default_rng(5)
            gc1 = rng_c.integers(0, 3, (n, p_corr), dtype=np.int8)
            gc2 = rng_c.integers(0, 3, (n, p_corr), dtype=np.int8)
            spec = ng.ModelSpec(
                y=y,
                fixed=[ng.FixedTerm("int", np.ones(n))],
                corr_markers=[CorrMarkerTerm(
                    ("C1", "C2"),
                    (ng.from_array(gc1), ng.from_array(gc2)),
                    ng.BayesPR(9999, np.array([[0.02, 0.005], [0.005, 0.015]])))],
                block_size=256,
            )
        else:
            spec = ng.ModelSpec(
                y=y,
                residual=residual,
                fixed=[ng.FixedTerm("int", np.ones(n))],
                markers=[ng.MarkerTerm("M1", from_device_array(g_dev), prior)],
                block_size=256,
            )
        plan, state = ng.assemble(spec, vshards=v)
        sweep = ng.make_sweep(plan)

        def multi(st, key):
            def body(s, _):
                return sweep(s, key), None
            st, _ = lax.scan(body, st, None, length=n_sweeps)
            return st

        step = jax.jit(multi, donate_argnums=0)
        key = jax.random.key(0)
        state = step(state, key)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        state = step(state, key)
        jax.block_until_ready(state)
        dt = (time.perf_counter() - t0) / n_sweeps
        if base is None:
            base = dt
        print(f"{name:12s}: {dt*1e3:7.2f} ms/sweep ({1.0/dt:6.1f} sweeps/s, "
              f"{dt/base:4.2f}x {list(cases)[0]})", flush=True)


main()
