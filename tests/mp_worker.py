"""Worker process for the true multi-process distributed test.

Invoked as: python mp_worker.py <process_id> <num_processes> <port> <out.npz>

Each worker owns 4 virtual CPU devices; the global mesh is (2 chains x
4 shards) over all processes' devices, so chains ride the cross-process
axis and marker-block psums cross the process boundary over gloo — the
CPU stand-in for the cross-host collectives of multihost.global_mesh.
"""
import sys


def build_model():
    """Deterministic small model, shared by workers and the in-process
    reference. Must not depend on process identity."""
    import numpy as np

    import nextgp_tpu as ng

    rng = np.random.default_rng(1234)
    n, p = 48, 64
    g = rng.integers(0, 3, (n, p)).astype(float)
    herd = rng.integers(0, 3, n)
    z = (herd[:, None] == np.arange(3)[None, :]).astype(float)
    y = 1.0 + (g - g.mean(0)) @ rng.normal(0, 0.2, p) + rng.normal(0, 1, n)
    spec = ng.ModelSpec(
        y=y,
        fixed=[ng.FixedTerm("int", np.ones(n))],
        random=[ng.RandomTerm("herd", z, prior=ng.Random("I", 0.5))],
        markers=[
            ng.MarkerTerm(
                "M1",
                ng.from_array(g),
                ng.BayesR([0.8, 0.1, 0.05, 0.05], [0.0, 1e-3, 1e-2, 1e-1], 1.0,
                          estimatePi=True),
            )
        ],
        block_size=8,
    )
    return ng.assemble(spec)


N_SWEEPS = 3
N_CHAINS = 2
N_SHARDS = 4


def run_sharded(plan, state, mesh):
    import jax

    from nextgp_tpu.parallel import sharded

    batched = sharded.distribute(plan, state, mesh, N_CHAINS)
    step = sharded.make_sharded_sweep(plan, mesh, n_sweeps=N_SWEEPS)(batched)
    keys = jax.random.split(jax.random.key(7), N_CHAINS)
    return step(batched, keys)


def main():
    pid, nproc, port, out_path = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])

    import os

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    jax.config.update("jax_enable_x64", True)
    from nextgp_tpu import backend

    backend.compile_cache()

    from nextgp_tpu.parallel import multihost

    assert multihost.init_distributed(f"127.0.0.1:{port}", nproc, pid)
    assert jax.process_count() == nproc
    assert len(jax.devices()) == N_CHAINS * N_SHARDS

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    plan, state = build_model()
    mesh = multihost.global_mesh(N_CHAINS, N_SHARDS)
    out = run_sharded(plan, state, mesh)

    # replicate the tracked outputs so every process can read them whole
    rep = NamedSharding(mesh, P())

    def gather(x):
        return np.asarray(jax.jit(lambda a: a, out_shardings=rep)(x))

    beta = gather(out.markers[0].beta)
    ycorr = gather(out.ycorr)
    var_e = gather(out.e.var_e)
    if pid == 0:
        np.savez(out_path, beta=beta, ycorr=ycorr, var_e=var_e)
    # block so process 0 finishes its write before peers tear down the
    # coordination service
    jax.experimental.multihost_utils.sync_global_devices("done")


if __name__ == "__main__":
    main()
