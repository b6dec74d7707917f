"""Serving utilities: genomic values (EBV) and out-of-sample prediction.

The reference leaves prediction to the user (EBV = M beta with the posterior
means read back from `betaOut`, e.g. docs/src/BWGR/BWGR.md:50-58). These
helpers make that a first-class, panel-size-safe operation:

* `genomic_values(md, beta)` — centered training-panel genomic values
  Mc @ beta. Works on plain int8 and 2-bit packed `MarkerData` alike; the
  packed path contracts directly on the packed bytes (the same planar
  unpack as ops/pack2.py, chunked over loci) so the unpacked panel never
  materializes.
* `predict(md_train, beta, new_genotypes)` — genomic values for NEW
  individuals: (new_genotypes - training centers) @ beta. Centering uses
  the TRAINING allele means (the model's parameterization); loci missing
  in the new panel are not supported — align columns upstream.

Both accept a posterior-mean vector (e.g. `res.posterior_mean("betaM1")`)
or any (p,) array.
"""
from __future__ import annotations

import numpy as np

from .data.ingest import MarkerData


def _beta_vec(beta, p):
    b = np.asarray(beta, dtype=np.float64).reshape(-1)
    if b.shape[0] != p:
        raise ValueError(f"beta has {b.shape[0]} entries, marker set has {p} loci")
    return b


def genomic_values(md: MarkerData, beta, chunk: int = 8192) -> np.ndarray:
    """Training-panel genomic values g = (M - center) @ beta, (nInd,) f64.

    Accumulation is host float64 regardless of where the panel lives:
    device-resident chunks are materialized via np.asarray before the
    shift/mask matmul (jax would otherwise run the contraction in f32)."""
    b = _beta_vec(beta, md.n_snp)
    offset = float(np.dot(np.asarray(md.center, np.float64), b))
    g = md.genotypes
    if getattr(g, "is_deleted", None) and g.is_deleted():
        raise ValueError(
            "marker panel buffer was donated: from_packed device panels are "
            "consumed by assemble's storage relayout. For a train-then-serve "
            "flow keep a host copy (from_packed(np.asarray(pk), ...)) or call "
            "genomic_values before assemble."
        )
    if not md.packed:
        # chunk over individuals so a device-resident panel transfers in
        # bounded pieces and math stays host f64
        n = md.n_ind
        out = np.empty(n, np.float64)
        for i0 in range(0, n, chunk):
            out[i0:i0 + chunk] = np.asarray(g[i0:i0 + chunk]).astype(np.float64) @ b
        return out - offset
    # packed rows: accumulate beta-weighted planar sums chunk-by-chunk
    pk = g  # (p, q) uint8
    q = pk.shape[1]
    acc = np.zeros(4 * q, np.float64)
    for i0 in range(0, pk.shape[0], chunk):
        blk = np.asarray(pk[i0:i0 + chunk]).astype(np.int32)
        bb = b[i0:i0 + chunk]
        for k in range(4):
            acc[k * q:(k + 1) * q] += ((blk >> (2 * k)) & 3).T.astype(np.float64) @ bb
    return acc[: md.n_ind] - offset


def genomic_values_state(plan, state, marker: int = 0, beta=None):
    """On-device genomic values from the ASSEMBLED marker storage:
    g = Mc @ beta computed straight off the packed (or int8) panel already
    resident in device memory — no host transfer, works mid-training with
    the current draw (beta=None) or any posterior-mean vector. One pass over
    the panel, in the same form as the sweep's scatter. Returns a device
    (n,) array in the engine dtype.

    The reference leaves EBV to user-side file post-processing
    (docs/src/BWGR/BWGR.md:50-58); this serves them from the live state.
    """
    import jax.numpy as jnp

    from .engine.samplers.markers import _panel_passes
    from .utils import HI

    mp = plan.markers[marker]
    ms = state.markers[marker]
    dtype = state.ycorr.dtype
    if beta is None:
        b_flat = ms.beta.astype(dtype)
    else:
        b_flat = jnp.zeros((mp.p_pad,), dtype).at[: mp.p].set(
            jnp.asarray(beta, dtype).reshape(-1)[: mp.p])

    mt = ms.mt
    if mt.ndim == 4:  # vshard layout (T, V, B, ncol); storage row (t, v, b)
        T, V, B = mt.shape[:3]
        u = jnp.swapaxes(b_flat.reshape(V, T, B), 0, 1).reshape(-1)
    else:
        u = b_flat
    cen = ms.center.reshape(-1).astype(dtype)  # same storage order as u
    _, scatter = _panel_passes(mp.packed, plan.n, dtype, mp.fused_passes)
    g = scatter(mt.reshape(-1, mt.shape[-1]), u)
    return g - jnp.dot(cen, u, precision=HI)


def predict(md_train: MarkerData, beta, new_genotypes) -> np.ndarray:
    """Genomic values for new individuals under the trained model:
    (new_genotypes - training centers) @ beta. new_genotypes (m, p) dosages
    in the TRAINING locus order."""
    b = _beta_vec(beta, md_train.n_snp)
    g = np.asarray(new_genotypes, dtype=np.float64)
    if g.ndim != 2 or g.shape[1] != md_train.n_snp:
        raise ValueError(
            f"new_genotypes must be (m, {md_train.n_snp}); got {g.shape}")
    return g @ b - float(np.dot(np.asarray(md_train.center, np.float64), b))
