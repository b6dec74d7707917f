"""CLI runner: config -> run -> summary round-trip."""
import json
import os

import numpy as np
import pytest

from nextgp_tpu import cli


def test_cli_run_and_summary(tmp_path, rng, capsys):
    n, p = 60, 40
    g = rng.integers(0, 3, (n, p))
    sex = rng.integers(0, 2, n)
    y = 1.0 + 0.5 * sex + (g - g.mean(0)) @ rng.normal(0, 0.2, p) + rng.normal(0, 1, n)

    with open(tmp_path / "pheno.csv", "w") as fh:
        fh.write("y,sex\n")
        for i in range(n):
            fh.write(f"{y[i]},{sex[i]}\n")
    np.savetxt(tmp_path / "geno.txt", g, fmt="%d")
    cfg = {
        "formula": "y ~ 1 + sex + SNP(M)",
        "data": "pheno.csv",
        "genotypes": {"M": "geno.txt"},
        "priors": {
            "M": {"type": "BayesC", "pi": 0.1, "v": 0.05, "estimatePi": True},
            "e": {"type": "Random", "str": "I", "v": 1.0},
        },
        "chain": {"length": 60, "burnin": 20, "thin": 10, "seed": 2},
        "block_size": 16,
        "vshards": "auto",  # production default; must not crash (cli.py)
        "out_folder": "out",
    }
    cfg_path = tmp_path / "analysis.json"
    cfg_path.write_text(json.dumps(cfg))

    rc = cli.main(["run", str(cfg_path), "--quiet"])
    assert rc == 0
    out = tmp_path / "out"
    assert (out / "betaMOut").exists() and (out / "piMOut").exists()

    rc = cli.main(["summary", "betaM", "--out-folder", str(out)])
    assert rc == 0
    captured = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(captured.split("\t")) == p

    rc = cli.main(["roofline", str(cfg_path), "--device", "NVIDIA H100 80GB HBM3"])
    assert rc == 0
    assert "roofline" in capsys.readouterr().out
    with pytest.raises(ValueError, match="peak table"):  # the CPU has no peaks
        cli.main(["roofline", str(cfg_path)])


def test_cli_vshards_parsing():
    assert cli._parse_vshards("auto") == "auto"
    assert cli._parse_vshards("Auto") == "auto"
    assert cli._parse_vshards("8") == 8
    assert cli._parse_vshards(8) == 8


def test_cli_prior_errors(tmp_path):
    assert "BayesR" in cli._PRIOR_BUILDERS
    try:
        cli._build_prior({"type": "Nope"})
        raise AssertionError("expected ValueError")
    except ValueError as e:
        assert "unknown prior" in str(e)


def test_cli_multichain_and_diag(tmp_path, rng, capsys):
    """chain.chains > 1 routes through run_chains (per-chain folders +
    R-hat summary); the diag subcommand reads them back."""
    n, p = 50, 24
    g = rng.integers(0, 3, (n, p))
    y = 1.0 + (g - g.mean(0)) @ rng.normal(0, 0.2, p) + rng.normal(0, 1, n)
    sex = rng.integers(0, 2, n)
    with open(tmp_path / "pheno.csv", "w") as fh:
        fh.write("y,sex\n")
        for v, sx in zip(y, sex):
            fh.write(f"{v},{sx}\n")
    np.savetxt(tmp_path / "geno.txt", g, fmt="%d")
    cfg = {
        "formula": "y ~ 1 + SNP(M)",
        "data": "pheno.csv",
        "genotypes": {"M": "geno.txt"},
        "priors": {"M": {"type": "BayesPR", "r": 9999, "v": 0.05}},
        "chain": {"length": 200, "burnin": 50, "thin": 10, "seed": 2,
                  "chains": 2, "track": ["varE", "betaM"]},
        "block_size": 8,
        "out_folder": "out",
    }
    cfg_path = tmp_path / "analysis.json"
    cfg_path.write_text(json.dumps(cfg))
    rc = cli.main(["run", str(cfg_path), "--quiet"])
    assert rc == 0
    assert (tmp_path / "out" / "chain1" / "varEOut").exists()
    assert (tmp_path / "out" / "chain2" / "varEOut").exists()
    assert "Rhat" in capsys.readouterr().out

    rc = cli.main(["diag", "varE", "--out-folder", str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert "split-Rhat" in out and "ESS" in out
    assert rc in (0, 2)


def test_cli_predict(tmp_path, rng, capsys):
    """predict subcommand serves training-panel EBVs and new-individual
    predictions from a finished run's posterior means."""
    n, p, m = 50, 24, 7
    g = rng.integers(0, 3, (n, p))
    sex = rng.integers(0, 2, n)
    y = 1.0 + (g - g.mean(0)) @ rng.normal(0, 0.3, p) + rng.normal(0, 1, n)
    with open(tmp_path / "pheno.csv", "w") as fh:
        fh.write("y,sex\n")
        for v, s in zip(y, sex):
            fh.write(f"{v},{s}\n")
    np.savetxt(tmp_path / "geno.txt", g, fmt="%d")
    g_new = rng.integers(0, 3, (m, p))
    np.savetxt(tmp_path / "new.txt", g_new, fmt="%d")
    cfg = {
        "formula": "y ~ 1 + sex + SNP(M)",
        "data": "pheno.csv",
        "genotypes": {"M": "geno.txt"},
        "priors": {"M": {"type": "BayesPR", "r": 9999, "v": 0.05},
                   "e": {"type": "Random", "str": "I", "v": 1.0}},
        "chain": {"length": 60, "burnin": 20, "thin": 10, "seed": 3},
        "block_size": 8,
        "out_folder": "out",
    }
    cfg_path = tmp_path / "analysis.json"
    cfg_path.write_text(json.dumps(cfg))
    assert cli.main(["run", str(cfg_path), "--quiet"]) == 0
    capsys.readouterr()  # drain the run command's status line

    out = str(tmp_path / "out")
    rc = cli.main(["predict", str(cfg_path), "--set", "M",
                   "--out-folder", out])
    assert rc == 0
    vals = [float(v) for v in capsys.readouterr().out.split()]
    assert len(vals) == n
    # cross-check against the library call
    from nextgp_tpu.io.summary import summary_mcmc
    import nextgp_tpu as ng

    beta = summary_mcmc("betaM", out_folder=out)
    md = ng.from_array(g.astype(float))
    np.testing.assert_allclose(vals, ng.genomic_values(md, beta), rtol=1e-6)

    ebv_file = tmp_path / "ebv_new.txt"
    rc = cli.main(["predict", str(cfg_path), "--set", "M", "--out-folder",
                   out, "--new", str(tmp_path / "new.txt"),
                   "--output", str(ebv_file)])
    assert rc == 0
    got = np.loadtxt(ebv_file)
    np.testing.assert_allclose(
        got, ng.predict(md, beta, g_new.astype(float)), rtol=1e-6)
    # unknown set errors cleanly
    assert cli.main(["predict", str(cfg_path), "--set", "NOPE",
                     "--out-folder", out]) == 2
