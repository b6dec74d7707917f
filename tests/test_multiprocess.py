"""True multi-process distributed execution (SURVEY.md §2.6 comm backend,
§4.6): the sharded sweep run across TWO OS processes (4 CPU devices each,
gloo collectives between them — the CPU stand-in for cross-host
collectives) must reproduce
the single-process 8-device chain. This exercises parallel/multihost.py
end to end: init_distributed, global_mesh, cross-process device_put inside
distribute, and psum/all_gather crossing the process boundary.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

sys.path.insert(0, os.path.dirname(__file__))
import mp_worker  # noqa: E402


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_two_process_matches_single_process(tmp_path):
    # in-process reference: same model, same (2 chains x 4 shards) mesh over
    # this process's 8 virtual devices
    from nextgp_tpu.parallel import sharded

    plan, state = mp_worker.build_model()
    mesh = sharded.make_mesh(mp_worker.N_CHAINS, mp_worker.N_SHARDS,
                             devices=jax.devices()[:8])
    ref = mp_worker.run_sharded(plan, state, mesh)
    ref_beta = np.asarray(ref.markers[0].beta)
    ref_ycorr = np.asarray(ref.ycorr)
    ref_var_e = np.asarray(ref.e.var_e)

    # two worker processes over gloo
    port = _free_port()
    out_path = tmp_path / "mp0.npz"
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port), str(out_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=420)[0] for p in procs]
    for p, text in zip(procs, outs):
        assert p.returncode == 0, f"worker {p.args[2]} failed:\n{text[-3000:]}"

    got = np.load(out_path)
    # both runs execute the identical logical program; CPU-vs-gloo psum
    # reduction order may differ in the last ulps, hence tolerance not
    # bit-equality (the single-process schedule equivalence is pinned
    # bit-exactly in test_sharded.py)
    np.testing.assert_allclose(got["beta"], ref_beta, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got["ycorr"], ref_ycorr, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got["var_e"], ref_var_e, rtol=1e-8)
