"""End-to-end smoke drive: BayesR signal recovery through the public API,
plus error-path probes. Used by the project verify skill.

Run: JAX_PLATFORMS=cpu python examples/e2e_smoke.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax

jax.config.update("jax_platforms", os.environ.get("NG_PLATFORM", "cpu"))
jax.config.update("jax_enable_x64", True)

from nextgp_tpu import backend  # noqa: E402

backend.compile_cache()

import numpy as np
import nextgp_tpu as ng


def main():
    rng = np.random.default_rng(7)
    n, p = 400, 600
    g = rng.integers(0, 3, size=(n, p)).astype(float)
    gc = g - g.mean(0)
    causal = rng.choice(p, 30, replace=False)
    beta_true = np.zeros(p)
    beta_true[causal] = rng.normal(0, 0.3, 30)
    y = 2.0 + gc @ beta_true + rng.normal(0, 1.0, n)

    spec = ng.ModelSpec(
        y=y,
        fixed=[ng.FixedTerm("intercept", np.ones(n))],
        markers=[
            ng.MarkerTerm(
                "M1",
                ng.from_array(g),
                ng.BayesR([0.9, 0.05, 0.03, 0.02], [0.0, 1e-4, 1e-3, 1e-2], 3.0, estimatePi=True),
            )
        ],
        block_size=64,
    )
    plan, state = ng.assemble(spec)
    sweep = jax.jit(ng.make_sweep(plan))
    key = jax.random.key(3)
    bsum = np.zeros(p)
    cnt = 0
    for i in range(600):
        state = sweep(state, key)
        if i >= 200 and i % 2 == 0:
            bsum += np.asarray(state.markers[0].beta[:p])
            cnt += 1
    bhat = bsum / cnt
    ebv_corr = np.corrcoef(gc @ bhat, gc @ beta_true)[0, 1]
    drift = float(
        jax.numpy.abs(
            state.ycorr
            - (y - np.asarray(state.fixed[0].b)[0] - gc @ np.asarray(state.markers[0].beta[:p]))
        ).max()
    )
    print(f"EBV corr = {ebv_corr:.4f}  (expect > 0.8)")
    print(f"exact-residual drift = {drift:.2e}  (expect < 1e-6)")
    print(f"piHat = {np.round(np.asarray(state.markers[0].pi_hat), 3)}")
    assert ebv_corr > 0.8 and drift < 1e-6

    for label, fn in [
        ("bad region size", lambda: ng.assemble(
            ng.ModelSpec(y=y, markers=[ng.MarkerTerm("M", ng.from_array(g), ng.BayesPR(50, 0.01))]))),
        ("row mismatch", lambda: ng.assemble(
            ng.ModelSpec(y=y[:100], markers=[ng.MarkerTerm("M", ng.from_array(g), None)]))),
        ("non-integer dosages", lambda: ng.from_array(g + 0.5)),
    ]:
        try:
            fn()
            raise SystemExit(f"probe {label}: expected ValueError")
        except ValueError as e:
            print(f"probe [{label}]: ValueError: {str(e)[:70]}")
    print("SMOKE OK")


if __name__ == "__main__":
    main()
