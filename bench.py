"""Headline benchmark: BayesR Gibbs sweep throughput on the local device.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Baseline: the reference's only marker-sweep timing evidence is the BWGR docs
example — ~81 sweeps/s at 12,414 SNPs, single CPU thread
(/root/reference/docs/src/BWGR/BWGR.md:37,58; see BASELINE.md). vs_baseline
is measured sweeps/s divided by 81, on a problem `NG_BENCH_P`/`NG_BENCH_N`
(default 49,152 SNPs x 10,000 individuals — ~20x more work per sweep than
the baseline problem). The run needs a GPU and refuses to time anything
else; the record on stderr names the device and the card's power limit.

Env overrides: NG_BENCH_N, NG_BENCH_P, NG_BENCH_BLOCK, NG_BENCH_SWEEPS,
NG_BENCH_VSHARDS.
"""
import json
import os
import sys
import time

import numpy as np


def main():
    import jax

    from nextgp_tpu import backend
    from nextgp_tpu.diag import card_info

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX runs on {jax.default_backend()!r}")
    backend.compile_cache()

    import nextgp_tpu as ng
    from nextgp_tpu.engine.sweep import make_sweep
    from jax import lax

    n = int(os.environ.get("NG_BENCH_N", 10000))
    p = int(os.environ.get("NG_BENCH_P", 49152))
    block = int(os.environ.get("NG_BENCH_BLOCK", 256))
    n_sweeps = int(os.environ.get("NG_BENCH_SWEEPS", 50))
    # virtual shards: V block chains advance per step (the multi-device
    # schedule run on one card; cuts the per-sweep sequential chain to p/V).
    # Default "auto" = the resolution every run_lmem user gets
    # (backend.auto_vshards) — the bench measures the out-of-the-box
    # configuration, not a hand-tuned one.
    _vs = os.environ.get("NG_BENCH_VSHARDS", "auto")
    vshards = _vs if _vs == "auto" else int(_vs)

    # simulate on the device: the int8 genotype matrix (0.5-30 GB) never
    # leaves it; only y (n floats) is pulled back for the ModelSpec.
    import functools

    import jax.numpy as jnp
    from nextgp_tpu.data.ingest import from_device_array, from_packed
    from nextgp_tpu.ops import pack2
    from nextgp_tpu.utils import HI

    key = jax.random.key(0)
    kg, kb, ke = jax.random.split(key, 3)

    def bt_fn(kb):
        # the planted sparse signal; regenerated identically in ebv_corr
        return jnp.where(
            jax.random.uniform(kb, (p,)) < 500.0 / p,
            jax.random.normal(kb, (p,)) * 0.1,
            0.0,
        )

    # panels too big to hold int8 alongside the working set are simulated in
    # column chunks and 2-bit packed as they are generated (from_packed path)
    # — a 50k x 600k panel is 7.4 GB packed, while its int8 form (30 GB)
    # never exists. Threshold 2 GB: the plain path's signal matmul
    # materializes an f32 copy of the panel, ~5x the int8 bytes.
    chunk_bytes = int(os.environ.get("NG_BENCH_CHUNK_BYTES", 2 << 30))
    use_packed_sim = n * p > chunk_bytes
    if use_packed_sim:
        q = pack2.packed_q(n)
        pc = max(block, (chunk_bytes // 8 // n // block) * block)
        assert p % block == 0, "chunked simulate wants block-aligned p"

        @functools.partial(jax.jit, static_argnames=("cols",))
        def sim_chunk(kc, bt_c, cols):
            g_c = jax.random.randint(kc, (n, cols), 0, 3, jnp.int8)
            gp = jnp.zeros((4 * q, cols), jnp.uint8).at[:n].set(g_c.astype(jnp.uint8))
            g4 = gp.reshape(4, q, cols)
            pk_c = (g4[0] | (g4[1] << 2) | (g4[2] << 4) | (g4[3] << 6)).T
            sig_c = jnp.matmul(g_c.astype(jnp.float32), bt_c, precision=HI)
            return pk_c, sig_c, jnp.mean(g_c.astype(jnp.float32), axis=0)

        upd = jax.jit(
            lambda buf, c, i: jax.lax.dynamic_update_slice(buf, c, (i, 0)),
            donate_argnums=0, static_argnums=2,
        )
        bt = jax.jit(bt_fn)(kb)
        pk_full = jnp.zeros((p, q), jnp.uint8)
        sig = jnp.zeros((n,), jnp.float32)
        centers = []
        for i0 in range(0, p, pc):
            cols = min(pc, p - i0)
            pk_c, sig_c, c_c = sim_chunk(
                jax.random.fold_in(kg, i0), jax.lax.dynamic_slice(bt, (i0,), (cols,)), cols
            )
            pk_full = upd(pk_full, pk_c, i0)
            sig = sig + sig_c
            centers.append(c_c)
        center = jnp.concatenate(centers)
        y_dev = sig - jnp.mean(sig) + jax.random.normal(ke, (n,))
        # sanity-check row subsample, taken NOW: assemble donates the packed
        # panel into its storage relayout, so pk_full is dead afterwards
        gs_pk = jax.jit(lambda a: a[:, :128])(pk_full)  # 512 individuals
        marker_data = from_packed(pk_full, n, center)
        g_dev = None
        del pk_full, sig, centers
    else:

        @jax.jit
        def simulate(key):
            kg, kb, ke = jax.random.split(key, 3)
            g = jax.random.randint(kg, (n, p), 0, 3, jnp.int8)
            sig = jnp.matmul(g.astype(jnp.float32), bt_fn(kb), precision=HI)
            y = sig - jnp.mean(sig) + jax.random.normal(ke, (n,))
            return g, y

        g_dev, y_dev = simulate(key)
        marker_data = from_device_array(g_dev)

    y = np.asarray(jax.device_get(y_dev), np.float64)

    spec = ng.ModelSpec(
        y=y,
        fixed=[ng.FixedTerm("int", np.ones(n))],
        markers=[
            ng.MarkerTerm(
                "M1",
                marker_data,
                ng.BayesR([0.9, 0.05, 0.03, 0.02], [0.0, 1e-4, 1e-3, 1e-2], 1.0, estimatePi=True),
            )
        ],
        block_size=block,
    )
    t0 = time.perf_counter()
    plan, state = ng.assemble(spec, vshards=vshards)
    t_assemble = time.perf_counter() - t0

    sweep = make_sweep(plan)

    def multi(state, key):
        def body(st, _):
            return sweep(st, key), None

        st, _ = lax.scan(body, state, None, length=n_sweeps)
        return st

    step = jax.jit(multi, donate_argnums=0)
    key = jax.random.key(0)

    t0 = time.perf_counter()
    state = step(state, key)
    jax.block_until_ready(state)
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    state = step(state, key)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    sweeps_per_sec = n_sweeps / dt

    # Emit the JSON line FIRST: the sanity check below is best-effort and
    # must never prevent the measurement from being recorded.
    print(
        json.dumps(
            {
                "metric": f"BayesR Gibbs sweeps/s ({n} ind x {p} SNPs, 1 GPU, est-pi)",
                "value": round(sweeps_per_sec, 2),
                "unit": "sweeps/s",
                "vs_baseline": round(sweeps_per_sec / 81.0, 2),
            }
        )
    )
    sys.stdout.flush()

    mp0 = plan.markers[0]
    ms_sweep = dt / n_sweeps * 1e3
    q_pk = pack2.packed_q(n)
    record = {
        "n": n, "p": p, "block": block, "sweeps": n_sweeps,
        "vshards": int(mp0.vshards), "packed": bool(mp0.packed),
        "sweeps_per_sec": round(sweeps_per_sec, 2),
        "ms_per_sweep": round(ms_sweep, 2),
        # 2 passes over the panel per sweep (gather + scatter)
        "packed_gbps": round(2 * p * q_pk / (ms_sweep * 1e-3) / 1e9, 1)
        if mp0.packed else None,
        "int8_equiv_gbps": round(2 * p * n / (ms_sweep * 1e-3) / 1e9, 1),
        "assemble_s": round(t_assemble, 1), "compile_s": round(t_compile, 1),
        "platform": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "card": card_info(),
        "route": mp0.route,
    }

    # chain-quality sanity: the current draw's genetic values should already
    # track the simulated signal after 2*n_sweeps sweeps (guards against a
    # fast-but-broken schedule). Row-subsampled to keep it cheap. The genotype
    # slice is passed as an argument: closing over g_dev would embed a
    # multi-hundred-MB constant in the program.
    @jax.jit
    def ebv_corr(gs_i8, beta_draw, key):
        kg, kb, ke = jax.random.split(key, 3)
        bt = jnp.where(
            jax.random.uniform(kb, (p,)) < 500.0 / p,
            jax.random.normal(kb, (p,)) * 0.1,
            0.0,
        )
        gs = gs_i8.astype(jnp.float32)
        ghat = jnp.matmul(gs, beta_draw.astype(jnp.float32), precision=HI)
        gtrue = jnp.matmul(gs, bt, precision=HI)
        ghat = ghat - jnp.mean(ghat)
        gtrue = gtrue - jnp.mean(gtrue)
        return jnp.vdot(ghat, gtrue) / jnp.sqrt(jnp.vdot(ghat, ghat) * jnp.vdot(gtrue, gtrue))

    corr = float("nan")
    try:
        if use_packed_sim:  # unpack the pre-sliced 512-individual subsample
            gs_i8 = jax.jit(lambda a: pack2.unpack2(a, jnp.int8).T)(gs_pk)
        else:
            gs_i8 = jax.lax.slice_in_dim(g_dev, 0, min(n, 2048), axis=0)
        corr = float(np.asarray(ebv_corr(gs_i8, state.markers[0].beta[:p], jax.random.key(0))))
    except Exception as exc:  # sanity check must not kill the bench record
        print(f"# ebv_corr sanity check failed: {exc}", file=sys.stderr)

    print(
        f"# assemble {t_assemble:.1f}s, compile {t_compile:.1f}s, "
        f"{dt / n_sweeps * 1e3:.1f} ms/sweep, EBV corr {corr:.3f} "
        f"after {2 * n_sweeps} sweeps",
        file=sys.stderr,
    )
    record["ebv_corr"] = None if corr != corr else round(corr, 4)
    print(json.dumps(record), file=sys.stderr)
    return record


if __name__ == "__main__":
    main()
