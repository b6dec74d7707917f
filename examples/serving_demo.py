"""Serving walkthrough: train -> EBVs -> out-of-sample prediction.

The reference leaves all of this to user-side file post-processing
(`/root/reference/docs/src/BWGR/BWGR.md:50-58`: read betaOut, multiply by
hand). Here the same flow is three calls:

  1. `run_lmem`                      — fit (the platform's schedule by default)
  2. `genomic_values_state`          — EBVs straight off the device-resident
                                       panel (no host transfer),
     or `genomic_values`             — host path from a MarkerData
  3. `predict`                       — new individuals under the TRAINING
                                       centering (the model's parameterization)

Run: JAX_PLATFORMS=cpu python examples/serving_demo.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import nextgp_tpu as ng
from nextgp_tpu.runtime import run_lmem


def main():
    rng = np.random.default_rng(11)
    n, p = 400, 600
    g = rng.integers(0, 3, (n, p)).astype(float)
    gc = g - g.mean(0)
    beta_true = np.where(rng.uniform(size=p) < 0.05, rng.normal(0, 0.4, p), 0.0)
    y = 2.0 + gc @ beta_true + rng.normal(0, 1.0, n)

    md = ng.from_array(g)
    spec = ng.ModelSpec(
        y=y,
        fixed=[ng.FixedTerm("int", np.ones(n))],
        markers=[ng.MarkerTerm("M", md, ng.BayesC(0.1, 0.05, estimatePi=True))],
        block_size=64,
    )
    res = run_lmem(spec, n_chain=800, n_burn=200, n_thin=5, out_folder=None, seed=3)
    beta_hat = res.posterior_mean("betaM")

    # EBVs three ways: live state (device), posterior mean via state, host
    ebv_live = np.asarray(ng.genomic_values_state(res.plan, res.state))
    ebv_mean = np.asarray(ng.genomic_values_state(res.plan, res.state, beta=beta_hat))
    ebv_host = ng.genomic_values(md, beta_hat)
    assert np.allclose(ebv_mean, ebv_host, atol=1e-3)
    acc = np.corrcoef(ebv_mean, gc @ beta_true)[0, 1]
    print(f"training EBV accuracy (posterior mean vs truth): {acc:.3f}")
    print(f"live-draw vs posterior-mean EBV corr: "
          f"{np.corrcoef(ebv_live, ebv_mean)[0, 1]:.3f}")

    # new individuals, centered with TRAINING allele means
    g_new = rng.integers(0, 3, (50, p)).astype(float)
    signal_new = (g_new - g.mean(0)) @ beta_true
    pred = ng.predict(md, beta_hat, g_new)
    acc_new = np.corrcoef(pred, signal_new)[0, 1]
    print(f"out-of-sample prediction accuracy: {acc_new:.3f}")
    assert acc > 0.7 and acc_new > 0.5
    print("SERVING DEMO OK")


if __name__ == "__main__":
    main()
