"""High-level entry points: the `runLMEM` / `prep` equivalents.

`run_lmem` mirrors the reference pipeline (`/root/reference/src/MCMC.jl:31-41`):
wipe the output folder -> build the model -> run the chain with thinned
output -> leave `<quantity>Out` files for `summary_mcmc`. Thinned draws are
additionally returned in memory as stacked arrays (the reference only
streams to disk).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import jax
import numpy as np

from .api.spec import ModelSpec
from .engine.plan import SweepPlan, assemble
from .engine.sweep import collect_sample, make_chain_runner
from .io.writer import MCMCWriter, folder_handler


def _headers(spec: ModelSpec, plan: SweepPlan) -> Dict[str, List[str]]:
    """Column headers matching the reference's output files (mme.jl:541-596)."""
    h: Dict[str, List[str]] = {"varE": ["e"]}
    blevels: List[str] = []
    by_name = {t.name: t for t in spec.fixed}
    for fp in plan.fixed:
        names = fp.name if isinstance(fp.name, tuple) else (fp.name,)
        for nm in names:
            t = by_name[nm]
            blevels += list(t.levels) if t.levels else (
                [nm] if t.n_col == 1 else [f"{nm}_{i + 1}" for i in range(t.n_col)]
            )
    if blevels:
        h["b"] = blevels
    for t, rp in zip(spec.random, plan.random):
        nm = rp.name if isinstance(rp.name, str) else "_".join(rp.name)
        lv = list(t.levels) if t.levels else [f"{nm}{i + 1}" for i in range(rp.q)]
        h[f"u{nm}"] = lv
        h[f"varU{nm}"] = [nm] if not rp.correlated else [
            f"{nm}_{i + 1}" for i in range(rp.n_t**2)
        ]
    for t, mp in zip(spec.markers, plan.markers):
        h[f"beta{mp.name}"] = list(t.data.snp_ids)
        h[f"delta{mp.name}"] = list(t.data.snp_ids)
        if mp.n_var == mp.p_pad:
            h[f"var{mp.name}"] = [f"reg_{i + 1}" for i in range(mp.p)]
        else:
            h[f"var{mp.name}"] = [f"reg_{i + 1}" for i in range(mp.n_var)]
        if mp.method in ("BayesB", "BayesC", "BayesR"):
            h[f"pi{mp.name}"] = [f"pi{v + 1}" for v in range(max(mp.n_classes, 2))]
        if mp.method in ("BayesRCpi", "BayesRCplus"):
            h[f"pi{mp.name}"] = [f"pi{v + 1}" for v in range(mp.n_classes * mp.n_annot)]
            h[f"annot{mp.name}"] = list(t.data.snp_ids)
        if mp.method == "BayesLV":
            h[f"c{mp.name}"] = [f"c{v + 1}" for v in range(mp.n_lv_cov)]
            h[f"varZeta{mp.name}"] = ["varZeta"]
    for ct, cp in zip(getattr(spec, "corr_markers", []), plan.corr_markers):
        for t, nm in enumerate(cp.names):
            ids = getattr(ct.datas[t], "snp_ids", None)
            h[f"beta{nm}"] = list(ids) if ids is not None else [
                f"{nm}_{i + 1}" for i in range(cp.p)]
        h[f"var{'_'.join(cp.names)}"] = [
            f"reg{r + 1}_{i + 1}_{j + 1}"
            for r in range(cp.n_regions)
            for i in range(cp.n_t) for j in range(cp.n_t)
        ]
    return h


def model_card(spec: ModelSpec, plan: SweepPlan, state=None) -> str:
    """Assemble-time summary of the resolved model: what the reference
    prints as input/analysis tables (prepMatVec.jl:172-173, mme.jl:537-538)
    and green prior-resolution notices (mme.jl:29-41,67-80,290,336). Every
    silently-substituted default is spelled out. With `state` (the
    assembled ModelState) the resolved prior scales are shown too — the
    reference's analysis-summary `scale` column (mme.jl:537-538)."""

    def _sc(container, i):
        if state is None:
            return ""
        try:
            s = np.asarray(getattr(state, container)[i].scale)
            if s.ndim == 0:
                return f", scale {float(s):g}"
            flat = s.ravel()
            if flat.size <= 6:
                return ", scale [" + ", ".join(f"{float(x):g}" for x in flat) + "]"
            head = ", ".join(f"{float(x):g}" for x in flat[:3])
            return f", scale [{head}, ...] ({flat.size} regions)"
        except (AttributeError, IndexError, TypeError, ValueError):
            return ""

    lines = [f"Model: n = {plan.n} observations, dtype {plan.dtype}"]
    res = spec.residual
    if res is None:
        lines.append("  residual: Random('I', 100.0)  [default — no 'e' prior given]")
    else:
        s = res.str_ if isinstance(res.str_, str) else "D (weights)"
        lines.append(f"  residual: Random({s!r}, {res.v})")
    e_sc = "" if state is None else f", scale = {float(np.asarray(state.e.scale)):g}"
    lines.append(f"    df = {plan.e_df}{e_sc}, weighted = {plan.weighted}")
    for fp in plan.fixed:
        nm = fp.name if isinstance(fp.name, str) else " + ".join(fp.name)
        kind = "blocked fixed" if isinstance(fp.name, tuple) else "fixed"
        lines.append(f"  {kind}: {nm}  ({fp.k} column{'s' if fp.k != 1 else ''})")
    # positional spec<->plan pairing: names can repeat (PED(Dam) + (1|Dam)
    # are both "Dam"), so a name-keyed dict would collapse them
    positional = len(spec.random) == len(plan.random)
    by_name = {t.name: t for t in spec.random}
    for i, rp in enumerate(plan.random):
        nm = rp.name if isinstance(rp.name, str) else " + ".join(rp.name)
        t = spec.random[i] if positional else by_name.get(rp.name)
        label = getattr(t, "structure_label", None) or "I"
        dflt = "" if (t is None or t.prior is not None) else "  [default Random('I', 100.0)]"
        corr = ", correlated" if rp.correlated else ""
        lines.append(
            f"  random: {nm}  ({rp.q} levels, structure {label}, "
            f"sampler {rp.sampler}{corr}, df {rp.df}{_sc('random', i)}){dflt}"
        )
    spec_m = {t.name: t for t in spec.markers}
    for mi, mp in enumerate(plan.markers):
        t = spec_m.get(mp.name)
        dflt = (
            "  [default BayesPR(9999, 0.05) — no prior given]"
            if (t is not None and t.prior is None)
            else ""
        )
        extra = []
        if mp.n_classes:
            extra.append(f"{mp.n_classes} classes")
        if mp.n_annot:
            extra.append(f"{mp.n_annot} annotations")
        if mp.method == "BayesPR":
            extra.append(f"{mp.n_regions} region{'s' if mp.n_regions != 1 else ''}")
        if mp.est_pi:
            extra.append("estimate pi")
        extra.append(f"df {mp.df}{_sc('markers', mi)}")
        extra.append(f"block {mp.block} x {mp.n_blocks}")
        if mp.vshards > 1:
            extra.append(f"vshards {mp.vshards}")
        if mp.route != "xla":
            extra.append(f"{mp.route} scan")
        lines.append(
            f"  markers: {mp.name}  ({mp.method}, {mp.p} loci, "
            + ", ".join(extra) + f"){dflt}"
        )
    for ci, cp in enumerate(plan.corr_markers):
        extra = ""
        if state is not None:
            try:
                import jax.numpy as _jnp

                if state.corr_markers[ci].mt.dtype == _jnp.uint8:
                    extra = ", 2-bit packed"
            except (AttributeError, IndexError):
                pass
        if cp.vshards > 1:
            extra += f", vshards {cp.vshards}"
        lines.append(
            f"  correlated markers: {' + '.join(cp.names)}  "
            f"(BayesPR, {cp.p} loci, {cp.n_t} sets, {cp.n_regions} regions"
            f"{extra})"
        )
    for key in spec.summary_stats:
        nm = key if isinstance(key, str) else " + ".join(key)
        lines.append(f"  summary statistics attached to: {nm}")
    return "\n".join(lines)


def _write_group_infos(spec: ModelSpec, out_folder: str) -> None:
    """groupInfo_<set>.txt per mapped BayesPR marker set, as the reference
    emits during setup (prep2RegionData, misc.jl:209)."""
    from .api import priors as P
    from .data.regions import build_regions, write_group_info

    for t in spec.markers:
        ci = getattr(t.data, "chr_ids", None)
        if ci is None or not isinstance(t.prior, P.BayesPR):
            continue
        info = build_regions(t.data.n_snp, t.prior.r, ci)
        write_group_info(out_folder, t.name, t.data.snp_ids, ci, info,
                         r=t.prior.r)


@dataclass
class LMEMResult:
    plan: SweepPlan
    state: Any
    draws: Dict[str, np.ndarray] = field(default_factory=dict)
    out_folder: Optional[str] = None
    sweeps_per_sec: float = 0.0

    def posterior_mean(self, name: str) -> np.ndarray:
        return np.asarray(self.draws[name]).mean(axis=0)


def run_lmem(
    spec: ModelSpec,
    n_chain: int,
    n_burn: int,
    n_thin: int,
    out_folder: Optional[str] = "outMCMC",
    seed: int = 0,
    dtype=None,
    keep_in_memory: bool = True,
    progress: bool = False,
    vshards="auto",
    checkpoint_every: int = 0,
    resume: bool = False,
) -> LMEMResult:
    """Single-chain MCMC mirroring runLMEM (MCMC.jl:31-41).

    Kept iterations are `(n_burn + n_thin) : n_thin : n_chain`
    (samplers.jl:26) — honored exactly for any (n_burn, n_thin), including
    `n_burn % n_thin != 0` (remainder burn sweeps run before the kept loop).

    vshards defaults to "auto": the platform's block-chain schedule
    (`backend.auto_vshards`), reference-sequential V=1 on the CPU.

    checkpoint_every=k writes `<out_folder>/chain.ckpt` every k kept samples
    (atomic, exact-resume: counter-based keys re-derive all randomness from
    sweep_index). resume=True restarts from that file if present — output
    files are then appended to, not wiped.
    """
    from .io.checkpoint import (
        load_checkpoint,
        plan_fingerprint,
        read_meta,
        save_checkpoint,
    )
    from .io.writer import truncate_outputs

    ckpt_path = os.path.join(out_folder, "chain.ckpt") if out_folder else None
    resuming = bool(resume and ckpt_path and os.path.exists(ckpt_path))
    if out_folder and not resuming:
        folder_handler(out_folder)
        _write_group_infos(spec, out_folder)
    plan, state = assemble(spec, dtype=dtype, vshards=vshards)
    if progress:
        print(model_card(spec, plan, state))
    fingerprint = plan_fingerprint(plan)
    runner = make_chain_runner(plan, n_thin)
    key = jax.random.key(seed)

    done_sweeps = 0
    if resuming:
        state = load_checkpoint(ckpt_path, state, fingerprint=fingerprint)
        done_sweeps = int(np.asarray(state.sweep_index))
        meta = read_meta(ckpt_path)
        if out_folder and "kept_rows" in meta:
            # rows spooled after the checkpoint would be re-emitted below;
            # cut the files back so resume is exact for outputs too
            truncate_outputs(out_folder, int(meta["kept_rows"]))
        if progress:
            print(f"  resumed at sweep {done_sweeps}")

    writer = (
        MCMCWriter(out_folder, None if resuming else _headers(spec, plan))
        if out_folder
        else None
    )
    draws: Dict[str, list] = {}

    # burn-in: thin-sized hops with the same compiled runner, plus a
    # remainder runner when n_burn % n_thin != 0 so the kept set equals
    # the reference rule (burn+thin):thin:chain for every input
    # (samplers.jl:26)
    n_keep = (n_chain - n_burn) // n_thin
    t0 = time.perf_counter()
    if done_sweeps < n_burn:
        for _ in range((n_burn - done_sweeps) // n_thin):
            state, _ = runner(state, key)
        left = (n_burn - done_sweeps) % n_thin
        if left:
            state, _ = make_chain_runner(plan, left)(state, key)
    for k in range(max(0, done_sweeps - n_burn) // n_thin, n_keep):
        state, sample = runner(state, key)
        if writer:
            writer.put(sample)
        if keep_in_memory:
            for nm, v in sample.items():
                draws.setdefault(nm, []).append(np.asarray(v))
        if checkpoint_every and ckpt_path and (k + 1) % checkpoint_every == 0:
            if writer:
                writer.flush()
            save_checkpoint(
                ckpt_path, state,
                meta={"fingerprint": fingerprint, "kept_rows": k + 1},
            )
        if progress and (k + 1) % max(1, n_keep // 10) == 0:
            print(f"  kept {k + 1}/{n_keep}")
    jax.block_until_ready(state.ycorr)
    dt = time.perf_counter() - t0
    ran_sweeps = n_burn + n_keep * n_thin - done_sweeps
    if writer:
        writer.close()
    return LMEMResult(
        plan=plan,
        state=state,
        draws={k: np.stack(v) for k, v in draws.items()},
        out_folder=out_folder,
        sweeps_per_sec=ran_sweeps / dt if dt > 0 else 0.0,
    )


def prep(spec: ModelSpec, dtype=None):
    """Standalone model inspection, mirroring exported `prep`
    (prepMatVec.jl:39-176): returns (plan, state) without sampling."""
    return assemble(spec, dtype=dtype)


def run_chains(
    spec: ModelSpec,
    n_chains: int,
    n_chain: int,
    n_burn: int,
    n_thin: int,
    seed: int = 0,
    dtype=None,
    n_shards: Optional[int] = None,
    mesh=None,
    track=("varE",),
    out_folder: Optional[str] = None,
    vshards="auto",
    checkpoint_every: int = 0,
    resume: bool = False,
    progress: bool = False,
) -> Dict[str, Any]:
    """Multi-chain MCMC over the device mesh (chains data-parallel, marker
    blocks sharded) with built-in cross-chain convergence diagnostics —
    the reference runs one chain and defers diagnostics to user-side
    MCMCChains scripts (docs/src/index.md:62-88).

    track: quantity names to keep in memory for R̂/ESS, or "all".
    out_folder: when set, every tracked quantity streams to
    `<out_folder>/chain<i>/<q>Out` TSVs in the reference layout, and
    `checkpoint_every`/`resume` give the batched multi-chain run the same
    exact-resume semantics as `run_lmem` (fingerprinted checkpoint +
    output-row truncation).

    Returns {"draws": {name: (n_chains, n_keep, ...)}, "rhat": {...},
    "ess": {...}, "state": batched ModelState}.
    """
    from .io.checkpoint import (
        load_checkpoint,
        plan_fingerprint,
        read_meta,
        save_checkpoint,
    )
    from .io.summary import ess_bulk, split_rhat
    from .io.writer import MCMCWriter, truncate_outputs
    from .parallel import sharded

    ckpt_path = os.path.join(out_folder, "chains.ckpt") if out_folder else None
    resuming = bool(resume and ckpt_path and os.path.exists(ckpt_path))
    if out_folder and not resuming:
        folder_handler(out_folder)
        _write_group_infos(spec, out_folder)

    plan, state = assemble(spec, dtype=dtype, vshards=vshards)
    fingerprint = plan_fingerprint(plan)
    if mesh is None:
        n_dev = len(jax.devices())
        if n_shards is None:
            # largest shard count <= devices/chains that every marker set's
            # block/vshard layout divides (an arbitrary default like
            # n_dev//n_chains rejects small models with few blocks)
            cap = max(1, n_dev // n_chains) if n_chains <= n_dev else 1
            n_shards = next(
                (s for s in range(cap, 0, -1)
                 if all((mp.vshards % s == 0) if mp.vshards > 1
                        else (mp.n_blocks % s == 0) for mp in plan.markers)
                 and all((cp.vshards % s == 0) if cp.vshards > 1
                         else (cp.n_blocks % s == 0)
                         for cp in plan.corr_markers)),
                1,
            )
        mesh = sharded.make_mesh(n_chains, n_shards,
                                 devices=jax.devices()[: n_chains * n_shards])
    batched = sharded.distribute(plan, state, mesh, n_chains)
    step = sharded.make_sharded_sweep(plan, mesh, n_sweeps=n_thin)(batched)
    keys = jax.random.split(jax.random.key(seed), n_chains)

    done_sweeps = 0
    if resuming:
        batched = load_checkpoint(ckpt_path, batched, fingerprint=fingerprint)
        done_sweeps = int(np.asarray(batched.sweep_index[0]))
        meta = read_meta(ckpt_path)
        if "kept_rows" in meta:
            for c in range(n_chains):
                truncate_outputs(
                    os.path.join(out_folder, f"chain{c + 1}"), int(meta["kept_rows"])
                )
        if progress:
            print(f"  resumed at sweep {done_sweeps}")

    writers = []
    if out_folder:
        headers = _headers(spec, plan)
        writers = [
            MCMCWriter(os.path.join(out_folder, f"chain{c + 1}"),
                       None if resuming else headers)
            for c in range(n_chains)
        ]

    n_keep = (n_chain - n_burn) // n_thin
    draws: Dict[str, list] = {}
    if done_sweeps < n_burn:
        for _ in range((n_burn - done_sweeps) // n_thin):
            batched = step(batched, keys)
        left = (n_burn - done_sweeps) % n_thin
        if left:  # remainder burn sweeps: exact reference kept set
            batched = sharded.make_sharded_sweep(plan, mesh, n_sweeps=left)(
                batched)(batched, keys)
    for k in range(max(0, done_sweeps - n_burn) // n_thin, n_keep):
        batched = step(batched, keys)
        sample = _collect_batched(batched, plan)
        names = list(sample.keys()) if track == "all" else [
            nm for nm in track if nm in sample
        ]
        for c, w in enumerate(writers):
            w.put({nm: sample[nm][c] for nm in names})
        for nm in names:
            draws.setdefault(nm, []).append(np.asarray(sample[nm]))
        if checkpoint_every and ckpt_path and (k + 1) % checkpoint_every == 0:
            for w in writers:
                w.flush()
            save_checkpoint(
                ckpt_path, batched,
                meta={"fingerprint": fingerprint, "kept_rows": k + 1},
            )
        if progress and (k + 1) % max(1, n_keep // 10) == 0:
            print(f"  kept {k + 1}/{n_keep}")
    for w in writers:
        w.close()
    out_draws = {k: np.stack(v, axis=1) for k, v in draws.items()}  # (C, keep, ...)
    rhat = {k: split_rhat(v if v.ndim > 2 else v[..., None]) for k, v in out_draws.items()}
    ess = {k: ess_bulk(v if v.ndim > 2 else v[..., None]) for k, v in out_draws.items()}
    return {"draws": out_draws, "rhat": rhat, "ess": ess, "state": batched}


def _collect_batched(batched, plan) -> Dict[str, Any]:
    """collect_sample over a chains-batched state: index chain c out of every
    chain-batched leaf (parallel.sharded._CHAIN_FIELDS), then collect."""
    import dataclasses as _dc

    from .parallel.sharded import _CHAIN_FIELDS

    def pick(obj, c):
        cls = type(obj)
        if _dc.is_dataclass(obj) and not isinstance(obj, type):
            kw = {}
            for f in _dc.fields(cls):
                v = getattr(obj, f.name)
                if cls in _CHAIN_FIELDS and f.name in _CHAIN_FIELDS[cls] and v is not None:
                    kw[f.name] = v[c]
                elif _dc.is_dataclass(v) and not isinstance(v, type):
                    kw[f.name] = pick(v, c)
                elif isinstance(v, tuple) and v and _dc.is_dataclass(v[0]):
                    kw[f.name] = tuple(pick(x, c) for x in v)
                else:
                    kw[f.name] = v
            return cls(**kw)
        return obj

    n_chains = batched.ycorr.shape[0]
    out: Dict[str, Any] = {}
    for c in range(n_chains):
        sample = collect_sample(pick(batched, c), plan)
        for k, v in sample.items():
            out.setdefault(k, []).append(np.asarray(v))
    return {k: np.stack(v) for k, v in out.items()}
