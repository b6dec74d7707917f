"""Observability: trace capture, roofline estimates, run metrics.

The reference's only observability is a progress bar
(`/root/reference/src/samplers.jl:29`) and the thinned TSV stream. Here the
sweep stages carry `jax.named_scope` annotations (engine/sweep.py), so a
profiler trace attributes device time to `gibbs.var_e` / `gibbs.fixed.*` /
`gibbs.marker.<set>`, and this module adds:

  * trace(...)        — context manager around jax.profiler.trace
  * roofline(...)     — analytic bytes/flops per sweep vs device peaks
  * SweepMeter        — wall-clock sweeps/s + ETA tracking for drivers
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

from .engine.plan import SweepPlan


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/nextgp_trace"):
    """Capture a jax.profiler trace of the enclosed block (view with
    tensorboard / xprof). Stage attribution comes from the named scopes."""
    import jax

    with jax.profiler.trace(log_dir, create_perfetto_link=False):
        yield log_dir


# Published peaks, keyed by JAX's device_kind: (f32 TFLOP/s outside the
# tensor cores, TF32 tensor-core TFLOP/s, device-memory GB/s). Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates at the
# 700 W limit. The sweep's products are f32 (precision pinned, utils.HI),
# so the f32 rate is the compute bound.
_DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (67.0, 495.0, 3350.0),
}


@dataclasses.dataclass
class RooflineReport:
    bytes_per_sweep: float
    flops_per_sweep: float
    intensity: float  # flops/byte
    t_bandwidth_s: float  # memory-bound lower bound
    t_compute_s: float  # f32-compute-bound lower bound
    bound: str
    sweeps_per_sec_roof: float

    def __str__(self) -> str:
        return (
            f"roofline: {self.bytes_per_sweep / 1e9:.2f} GB + "
            f"{self.flops_per_sweep / 1e12:.3f} TFLOP per sweep "
            f"(AI {self.intensity:.1f}); {self.bound}-bound; "
            f"roof {self.sweeps_per_sec_roof:.1f} sweeps/s"
        )


def roofline(plan: SweepPlan, device: Optional[str] = None,
             n_shards: int = 1) -> RooflineReport:
    """Analytic per-sweep traffic/flops of the blocked marker sweep against
    a device's published peaks (device: a JAX device_kind, default the
    running device's; a device the table lacks is an error).

    Per marker set: the int8 mt is read twice per sweep (r0 matvec +
    correction rank-B update), the Gram blocks once, plus the in-block scan
    (p x B MACs) — SURVEY.md §3.5 re-derived for the blocked formulation.
    """
    if device is None:
        import jax

        device = jax.devices()[0].device_kind
    if device not in _DEVICE_PEAKS:
        raise ValueError(
            f"device {device!r} is not in the peak table; one of {sorted(_DEVICE_PEAKS)}")
    f32_tflops, _, hbm = _DEVICE_PEAKS[device]
    n = plan.n
    bytes_total = 0.0
    flops = 0.0
    for mp in plan.markers:
        p_local = mp.p_pad / max(1, n_shards)
        itemsize = 0.25 if getattr(mp, "packed", False) else 1  # pack2 / int8
        bytes_total += 2 * p_local * n * itemsize  # two passes over mt
        bytes_total += p_local * mp.block * 4  # Gram blocks (f32)
        flops += 2 * 2 * p_local * n  # matvec + rank-B update MACs
        flops += 2 * p_local * mp.block  # in-block Gram-row dots
    bytes_total += 20 * 4 * n  # ycorr/fixed/random traffic (minor)
    t_bw = bytes_total / (hbm * 1e9)
    t_fl = flops / (f32_tflops * 1e12)
    bound = "bandwidth" if t_bw >= t_fl else "compute"
    t = max(t_bw, t_fl)
    return RooflineReport(
        bytes_per_sweep=bytes_total,
        flops_per_sweep=flops,
        intensity=flops / max(bytes_total, 1.0),
        t_bandwidth_s=t_bw,
        t_compute_s=t_fl,
        bound=bound,
        sweeps_per_sec_roof=1.0 / t if t > 0 else float("inf"),
    )


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them
    ("name, power.limit" per GPU, one per line). A card set below its
    maximum power runs slower under load, so this goes beside every time
    the benchmark prints. Raises when nvidia-smi is missing or fails."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


class SweepMeter:
    """Wall-clock throughput tracker (replaces @showprogress, samplers.jl:29)."""

    def __init__(self, total_sweeps: Optional[int] = None):
        self.total = total_sweeps
        self.done = 0
        self.t0 = time.perf_counter()

    def tick(self, n_sweeps: int = 1) -> None:
        self.done += n_sweeps

    @property
    def sweeps_per_sec(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.done / dt if dt > 0 else 0.0

    @property
    def eta_s(self) -> Optional[float]:
        if not self.total or self.done == 0:
            return None
        return (self.total - self.done) / max(self.sweeps_per_sec, 1e-9)

    def status(self) -> str:
        eta = self.eta_s
        tail = f", ETA {eta:.0f}s" if eta is not None else ""
        return f"{self.done} sweeps @ {self.sweeps_per_sec:.1f}/s{tail}"
