"""Genotype ingestion: file/array -> centered marker set for the device.

Reference behavior (`/root/reference/src/prepMatVec.jl:113-134`): read a
space-delimited headerless genotype file, drop any column containing a
missing value, mean-center columns, keep dense f64. This package instead
keeps the raw 0/1/2 dosages as int8 (device-resident; 4x less bandwidth
than f32) plus an f32 center vector, and applies centering algebraically inside
the kernels: m_centered[:, j] = g[:, j] - center[j].
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class MarkerData:
    """Host-side marker set. genotypes int8 (nInd, nSNP), center f32 (nSNP,).

    packed=True means genotypes holds 2-bit planar-packed rows instead:
    (nSNP, q) uint8 with q = ops.pack2.packed_q(nInd) (see ops/pack2.py) —
    the storage `assemble` would build anyway, built upstream so a 600k-SNP
    panel never exists unpacked (30 GB int8 vs 7.5 GB packed at 50k ind).
    """

    genotypes: np.ndarray
    center: np.ndarray
    snp_ids: list
    chr_ids: Optional[np.ndarray] = None
    sample_ids: Optional[list] = None
    packed: bool = False
    packed_n_ind: Optional[int] = None

    @property
    def n_ind(self) -> int:
        return self.packed_n_ind if self.packed else self.genotypes.shape[0]

    @property
    def n_snp(self) -> int:
        return self.genotypes.shape[0] if self.packed else self.genotypes.shape[1]

    def centered(self, dtype=np.float64) -> np.ndarray:
        """Dense centered marker matrix (what the reference stores)."""
        if self.packed:
            from ..ops import pack2

            g = np.asarray(pack2.unpack2(np.asarray(self.genotypes), dtype)).T
            g = g[: self.n_ind]
            return g - np.asarray(self.center, dtype)[None, :]
        return self.genotypes.astype(dtype) - self.center.astype(dtype)[None, :]


def from_array(m, snp_ids=None, chr_ids=None, drop_missing=True) -> MarkerData:
    """Build a MarkerData from an (nInd, nSNP) dosage array. NaN entries mark
    missing; columns with any missing value are dropped (prepMatVec.jl:118)."""
    m = np.asarray(m, dtype=np.float64)
    p0 = m.shape[1]
    keep = np.ones(p0, dtype=bool)
    if drop_missing:
        keep = ~np.isnan(m).any(axis=0)
    m = m[:, keep]
    if snp_ids is None:
        snp_ids = [f"M{i + 1}" for i in range(p0)]
    snp_ids = [s for s, k in zip(snp_ids, keep) if k]
    if chr_ids is not None:
        chr_ids = np.asarray(chr_ids)[keep]
    center = m.mean(axis=0)  # keep f64 host-side; planner casts per device dtype
    g = m.astype(np.int8)
    if not np.array_equal(g.astype(np.float64), m):
        # non-integer dosages: store residual-exact centered floats via
        # rounding-free fallback (center absorbs the fractional part only
        # when dosages are integer; otherwise keep f32 matrix semantics)
        raise ValueError(
            "genotypes must be integer dosages (0/1/2); use from_float_array "
            "for arbitrary real-valued covariate panels"
        )
    return MarkerData(genotypes=g, center=center, snp_ids=snp_ids, chr_ids=chr_ids)


def from_float_array(m, snp_ids=None, chr_ids=None) -> MarkerData:
    """Arbitrary real-valued marker panel: falls back to quantization-free
    storage by keeping a float genotype matrix. Center is still the column
    mean. Host storage stays float64 — the reference stores centered f64
    (prepMatVec.jl:129) and the f64 golden/equivalence chains must see the
    exact input values; `assemble` casts to the engine dtype (f32 by default)
    only when building the device storage."""
    m = np.asarray(m, dtype=np.float64)
    if snp_ids is None:
        snp_ids = [f"M{i + 1}" for i in range(m.shape[1])]
    center = m.mean(axis=0, dtype=np.float64)
    md = MarkerData(genotypes=m, center=center, snp_ids=list(snp_ids), chr_ids=chr_ids)
    return md


def _finish_int8(g, col_sum, col_n, snp_ids=None, chr_ids=None, drop_missing=True) -> MarkerData:
    """Shared tail for the native readers: drop missing-containing columns
    (prepMatVec.jl:118) and compute centers from the fused column sums."""
    n, p0 = g.shape
    keep = col_n == n if drop_missing else np.ones(p0, bool)
    g = np.ascontiguousarray(g[:, keep])
    center = col_sum[keep] / np.maximum(col_n[keep], 1)
    if snp_ids is None:
        snp_ids = [f"M{i + 1}" for i in range(p0)]
    snp_ids = [s for s, k in zip(snp_ids, keep) if k]
    if chr_ids is not None:
        chr_ids = np.asarray(chr_ids)[keep]
    return MarkerData(genotypes=g, center=center, snp_ids=snp_ids, chr_ids=chr_ids)


def from_device_array(g, snp_ids=None, chr_ids=None) -> MarkerData:
    """MarkerData over a device-resident (jax.Array) dosage matrix; centering
    stats computed on device. For synthetic/bench pipelines where shipping
    the matrix through the host would dominate wall time."""
    import jax
    import jax.numpy as jnp

    # f64 where enabled (exact, matches the host path under tests); silently
    # f32 in the default config. jit fuses the convert into the reduction so
    # no full-precision copy of g is ever materialized (a 50k x 75k int8
    # matrix would need a 15 GB f32 copy otherwise).
    acc = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    center = jax.jit(lambda a: jnp.mean(a, axis=0, dtype=acc))(g)
    if snp_ids is None:
        snp_ids = [f"M{i + 1}" for i in range(g.shape[1])]
    return MarkerData(genotypes=g, center=center, snp_ids=list(snp_ids), chr_ids=chr_ids)


def from_packed(pk, n_ind: int, center, snp_ids=None, chr_ids=None) -> MarkerData:
    """MarkerData over already 2-bit-packed genotype rows.

    pk: (nSNP, q) uint8 planar-packed (ops/pack2.py layout, q =
    packed_q(n_ind)); center: (nSNP,) column means of the unpacked dosages.
    Device or host arrays both work; `assemble` consumes the rows as its
    storage without ever materializing the unpacked panel. NOTE: a
    device-resident pk is DONATED to the storage relayout inside assemble
    (the panel is assumed too large to hold twice), so it must not be reused
    afterwards. This is the ingestion path for beyond-HBM synthetic panels
    and for packed caches of .bed filesets (a 50k x 600k panel is 7.5 GB
    packed vs 30 GB int8)."""
    from ..ops import pack2

    q_want = pack2.packed_q(n_ind)
    if pk.dtype != np.uint8 or pk.ndim != 2 or pk.shape[1] != q_want:
        raise ValueError(
            f"packed rows must be (nSNP, {q_want}) uint8 for n_ind={n_ind}; "
            f"got {pk.shape} {pk.dtype}"
        )
    p = pk.shape[0]
    center = np.asarray(center, np.float64) if not hasattr(center, "devices") else center
    if snp_ids is None:
        snp_ids = [f"M{i + 1}" for i in range(p)]
    return MarkerData(
        genotypes=pk, center=center, snp_ids=list(snp_ids), chr_ids=chr_ids,
        packed=True, packed_n_ind=int(n_ind),
    )


def read_genotype_file(path: str, delim: str = " ", drop_missing=True) -> MarkerData:
    """Space-delimited headerless genotype file (prepMatVec.jl:116).

    Uses the multithreaded native parser (native/src/nextgp_native.cpp) when
    available; pure-Python fallback otherwise.
    """
    from .. import native

    if native.available():
        from ..native import api as nat

        try:
            g, col_sum, col_n = nat.parse_genotypes(path)
            return _finish_int8(g, col_sum, col_n, drop_missing=drop_missing)
        except ValueError as exc:
            if "non-integral" not in str(exc):
                raise
            # fractional dosages: fall through to the float reader — the
            # reference accepts any real-valued genotype file and stores
            # centered floats (prepMatVec.jl:129)
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rows.append([np.nan if t in ("NA", ".", "NaN", "nan") else float(t) for t in line.split()])
    m = np.asarray(rows, np.float64)
    keep = ~np.isnan(m).any(axis=0) if drop_missing else np.ones(m.shape[1], bool)
    mk = m[:, keep]
    if np.array_equal(mk, np.round(mk)) and 0 <= mk.min() and mk.max() <= 127:
        return from_array(m, drop_missing=drop_missing)
    return from_float_array(
        mk, snp_ids=[f"M{i + 1}" for i in np.flatnonzero(keep)])


def _bed_decode_numpy(path: str, n: int, p: int):
    """Pure-NumPy PLINK .bed decode (SNP-major v1.0)."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size < 3 or raw[0] != 0x6C or raw[1] != 0x1B or raw[2] != 0x01:
        raise ValueError(f"{path!r}: bad .bed magic (need SNP-major v1.0)")
    bps = (n + 3) // 4
    body = raw[3 : 3 + bps * p].reshape(p, bps)
    # 2-bit fields, little-endian within the byte
    codes = np.stack(
        [(body >> (2 * k)) & 3 for k in range(4)], axis=2
    ).reshape(p, bps * 4)[:, :n]
    lut = np.array([2, -1, 1, 0], np.int8)  # 00 hom-A1, 01 missing, 10 het, 11 hom-A2
    g = lut[codes].T  # (n, p)
    ok = g >= 0
    col_sum = np.where(ok, g, 0).sum(axis=0).astype(np.float64)
    col_n = ok.sum(axis=0).astype(np.int64)
    return np.ascontiguousarray(g), col_sum, col_n


def read_plink(prefix: str, drop_missing=True) -> MarkerData:
    """PLINK binary fileset `prefix`.bed/.bim/.fam -> MarkerData (dosage of
    the A1 allele). An ingestion format the reference lacks; at 600k-SNP
    scale .bed is ~25x smaller than the text format of prepMatVec.jl:116."""
    from .. import native

    fam = [ln.split() for ln in open(prefix + ".fam") if ln.strip()]
    bim = [ln.split() for ln in open(prefix + ".bim") if ln.strip()]
    n, p = len(fam), len(bim)
    snp_ids = [r[1] for r in bim]
    chr_raw = [r[0] for r in bim]
    try:
        chr_ids = np.asarray([int(c) for c in chr_raw])
    except ValueError:
        _, chr_ids = np.unique(chr_raw, return_inverse=True)
    if native.available():
        from ..native import api as nat

        g, col_sum, col_n = nat.read_bed(prefix + ".bed", n, p)
    else:
        g, col_sum, col_n = _bed_decode_numpy(prefix + ".bed", n, p)
    md = _finish_int8(g, col_sum, col_n, snp_ids, chr_ids, drop_missing)
    md.sample_ids = [r[1] for r in fam]
    return md


def read_map_file(path: str):
    """Map file with header `snpID,snpOrder,chrID` (misc.jl:167 expects these
    columns; commas or whitespace accepted). Returns (snp_ids, chr_ids)."""
    snp_ids, chr_ids = [], []
    with open(path) as fh:
        header = fh.readline().replace(",", " ").split()
        cols = {c: i for i, c in enumerate(header)}
        for line in fh:
            parts = line.replace(",", " ").split()
            if not parts:
                continue
            snp_ids.append(parts[cols.get("snpID", 0)])
            chr_ids.append(int(float(parts[cols.get("chrID", 2)])))
    return snp_ids, np.asarray(chr_ids)
