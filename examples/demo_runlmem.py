"""Full-pipeline drive: formula front-end -> run_lmem -> output files ->
summary_mcmc round-trip. Mirrors the reference's PBLUP + BWGR docs examples
(/root/reference/docs/src/PBLUP/PBLUP.md, docs/src/BWGR/BWGR.md).

Run: JAX_PLATFORMS=cpu python examples/demo_runlmem.py
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import jax

jax.config.update("jax_platforms", os.environ.get("NG_PLATFORM", "cpu"))
jax.config.update("jax_enable_x64", True)

from nextgp_tpu import backend  # noqa: E402

backend.compile_cache()

import numpy as np
import nextgp_tpu as ng


def main():
    rng = np.random.default_rng(11)
    n, p = 300, 400

    # pedigree: 60 founders, then offspring of random earlier animals
    n_ped = 360
    sire = ["0"] * n_ped
    dam = ["0"] * n_ped
    for i in range(60, n_ped):
        s, d = rng.integers(0, i, 2)
        sire[i] = f"A{s + 1}" if s != d else "0"
        dam[i] = f"A{d + 1}"
    ped_lines = "\n".join(f"A{i + 1} {sire[i]} {dam[i]}" for i in range(n_ped))

    ids = [f"A{i + 1}" for i in rng.choice(n_ped, n, replace=False)]
    herd = rng.integers(0, 5, n)
    sex = rng.integers(0, 2, n)
    g = rng.integers(0, 3, (n, p)).astype(float)
    gc = g - g.mean(0)
    beta_true = np.zeros(p)
    causal = rng.choice(p, 25, replace=False)
    beta_true[causal] = rng.normal(0, 0.3, 25)
    y = 3.0 + 0.5 * sex + gc @ beta_true + rng.normal(0, 1.0, n)

    with tempfile.TemporaryDirectory() as td:
        ped_path = os.path.join(td, "ped.txt")
        with open(ped_path, "w") as fh:
            fh.write(ped_lines + "\n")
        geno_path = os.path.join(td, "geno.txt")
        np.savetxt(geno_path, g, fmt="%d")

        data = {"y": y, "ID": np.array(ids), "sex": sex, "herd": herd}
        spec = ng.parse_formula(
            "y ~ 1 + sex + (1|herd) + PED(ID) + SNP(M, geno)",
            data,
            priors={
                "M": ng.BayesPR(9999, 0.05),
                "ID": ng.Random("A", 0.5),
                "herd": ng.Random("I", 0.3),
                "e": ng.Random("I", 1.0),
            },
            path2ped=ped_path,
            genotypes={"M": geno_path},
            block_size=64,
        )
        out = os.path.join(td, "outMCMC")
        res = ng.run_lmem(spec, n_chain=400, n_burn=100, n_thin=10, out_folder=out, seed=1)

        files = sorted(os.listdir(out))
        print("output files:", files)
        for req in ("bOut", "varEOut", "betaMOut", "uIDOut", "varUIDOut"):
            assert req in files, f"missing {req}"

        ve = ng.summary_mcmc("varE", out_folder=out)
        bhat = ng.summary_mcmc("betaM", out_folder=out)
        assert bhat.shape == (p,)
        ebv_corr = np.corrcoef(gc @ bhat, gc @ beta_true)[0, 1]
        print(f"posterior varE = {float(np.squeeze(ve)):.3f} (sim 1.0)")
        print(f"EBV corr = {ebv_corr:.4f} (expect > 0.7)")
        print(f"sweeps/s = {res.sweeps_per_sec:.1f}")

        # in-memory draws agree with the files
        np.testing.assert_allclose(
            res.posterior_mean("betaM"), bhat, rtol=0, atol=1e-9)
        assert ebv_corr > 0.7
    print("RUNLMEM DEMO OK")


if __name__ == "__main__":
    main()
