"""GRN vertical throughput (est_grn) at production-ish shapes.

The reference's estGRN_MHGibbs inverts a dense (G^2-G)^2 matrix per
iteration (GRN.jl:199) — O(G^6) — and loops Lambda2 site-by-site in
Julia. The engine's YY'-block collapse inverts G batched (G-1)^2 blocks
(O(G^4)) and vmaps the per-gene scans, so gene panels in the hundreds
are practical. This prints iterations/s at a ladder of (G, S, N) and one
JSON record naming the device.

Run: python scripts/bench_grn.py    (BG_SHAPES="G,S,N;...")
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import jax
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    from nextgp_tpu import backend

    backend.compile_cache()
    from nextgp_tpu.grn.sampler import GRNPlan, GRNState, make_grn_step
    import jax.numpy as jnp

    shapes = os.environ.get("BG_SHAPES", "10,20,2000;30,60,5000;100,200,10000")
    rec = {"experiment": "bench_grn", "platform": jax.default_backend(),
           "device_kind": jax.devices()[0].device_kind,
           "date": __import__("datetime").date.today().isoformat()}
    for spec in shapes.split(";"):
        G, S, N = (int(x) for x in spec.split(","))
        rng = np.random.default_rng(1)
        x = rng.integers(0, 3, (S, N)).astype(np.float64)
        l1 = np.zeros((G, G))
        for g in range(1, G):
            l1[g, g - 1] = 0.3 * (1 if g % 2 else -1)
        l2 = rng.normal(0, 0.3, (G, S)) * (rng.uniform(size=(G, S)) < 0.1)
        mu = rng.normal(0, 1, G)
        e = rng.normal(0, 0.5, (G, N))
        xc = x - x.mean(axis=1, keepdims=True)
        y = np.linalg.solve(np.eye(G) - l1, mu[:, None] + l2 @ xc + e)

        dtype = jnp.float32
        n_l = G * G - G
        df = 4.0
        plan = GRNPlan(n_genes=G, n_snps=S, n_ind=N, mean_lam1=0.0,
                       nu_s_l1=5e-4 * (df - 2.0), df_l1=df,
                       nu_s_beta=5e-4 * (df - 2.0), df_beta=df,
                       nu_s_e=1.0 * (df - 2.0), df_e=df)
        mu0 = y.mean(axis=1)
        yc0 = y - mu0[:, None]
        state = GRNState(
            mu=jnp.asarray(mu0, dtype), lam1=jnp.zeros((n_l,), dtype),
            lam2=jnp.zeros((G, S), dtype),
            var_lam1=jnp.asarray(5e-4, dtype),
            var_beta=jnp.full((G,), 5e-4, dtype),
            var_e=jnp.asarray(1.0, dtype),
            ycorr=jnp.asarray(yc0, dtype),
            accept=jnp.asarray(0, jnp.int32), it=jnp.asarray(0, jnp.int32),
        )
        step = jax.jit(make_grn_step(plan, jnp.asarray(xc, dtype),
                                     jnp.asarray(yc0, dtype), dtype))
        key = jax.random.key(0)
        n_it = 50
        st = state
        for _ in range(2):  # compile + warm
            st = step(st, key)
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        for _ in range(n_it):
            st = step(st, key)
        jax.block_until_ready(st)
        dt = (time.perf_counter() - t0) / n_it
        rec[f"G={G} S={S} N={N}"] = round(dt * 1e3, 2)
        print(f"G={G:4d} S={S:4d} N={N:6d}: {dt*1e3:8.2f} ms/iter "
              f"({1/dt:7.1f} it/s)  accept={int(st.accept)}/{n_it+2}",
              flush=True)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
