"""What runs where: the one module that looks at the platform.

Everything else takes its answers from here, through `assemble` and the
plan it builds:

* the kernel route of the in-block scan: "triton" (the Pallas kernels of
  ops/gibbs_kernels.py) on a GPU, "xla" (the plain `lax.scan`) elsewhere;
* the platform half of `vshards="auto"`;
* the default genotype storage (int8 or 2-bit packed);
* the compile-cache rule.

A kernel route is never emulated behind the caller's back: asking for the
Triton route off a GPU raises unless the caller asks for the Pallas
interpreter explicitly (which is how the CPU tests run the kernels).
"""
from __future__ import annotations

import os
from typing import Optional

import jax

ROUTES = ("triton", "xla")

# vshards="auto" on a GPU: the largest divisor of the block count up to
# this many concurrent chains. See `auto_vshards` for the evidence.
GPU_MAX_VSHARDS = 128


def platform() -> str:
    return jax.default_backend()


def kernel_route(platform_: Optional[str] = None) -> str:
    """The in-block scan route for a platform (default: the running one).

    On the GPU XLA's scan pays a kernel launch per dependent locus; the
    Triton kernels run a block's whole chain in one program. Whole-sweep
    rates at 10,000 x 49,152 on the H100 above (sweeps/s, Triton / XLA):
    BayesR est-pi 606-645 / 35-67 at V = 96 and 23 / 1.6 at V = 1;
    weighted BayesC 545-571 / 142-143 and 24 / 2.3; BayesRCplus 544-548 /
    10-12 and 13 / 0.2."""
    return "triton" if (platform_ or platform()) == "gpu" else "xla"


def resolve_route(route: Optional[str] = None, interpret: bool = False,
                  platform_: Optional[str] = None) -> str:
    """Validate a requested route (None: the platform's own)."""
    plat = platform_ or platform()
    route = route or kernel_route(plat)
    if route not in ROUTES:
        raise ValueError(f"unknown kernel route {route!r}; one of {ROUTES}")
    if route == "triton" and plat != "gpu" and not interpret:
        raise RuntimeError(
            f"the Triton kernel route needs a GPU (running on {plat!r}); "
            "pass interpret=True to run the kernels in the Pallas "
            "interpreter, or route='xla'")
    return route


def auto_vshards(n_blocks: int, platform_: Optional[str] = None) -> int:
    """V for vshards="auto": how many block chains advance per block step.

    CPU (and any platform but the GPU): 1, the reference-sequential order
    that the golden tests pin.

    GPU: the largest divisor of the block count up to GPU_MAX_VSHARDS.
    The sweep's dependent chain is p / V loci long, and the V chains of a
    step run side by side (one Triton program each). Measured on an H100
    80GB HBM3 (400 W power limit), BayesR with estimated pi at 10,000 x
    49,152, B = 256 (192 blocks), Triton route, sweeps/s by V:

        V    1    8    32   64   96   192
            23  150  395  545  710  870

    The rate still rises past the card's 132 SMs, but by less per chain
    (x1.3 from 64 to 96, x1.2 from 96 to 192), while every further chain
    makes the schedule staler: more loci drawn against the residual of the
    same block step. 128 keeps at least two block steps per sweep at this
    size and 18 at 50,000 x 589,824."""
    if (platform_ or platform()) != "gpu":
        return 1
    return max(v for v in range(1, min(n_blocks, GPU_MAX_VSHARDS) + 1)
               if n_blocks % v == 0)


def default_pack(platform_: Optional[str] = None) -> bool:
    """Default genotype storage for eligible (0..3) dosages: 2-bit packed
    on the GPU, int8 elsewhere. On the H100 above (V = 96, fused passes)
    the two storages ran the sweep at the same rate (packed 715-724,
    int8 683-726 sweeps/s), so the GPU takes the one with a quarter of the
    device memory."""
    return (platform_ or platform()) == "gpu"


def fused_passes(route: str) -> bool:
    """Panel passes as fused multiply-and-reduce (the Triton route's GPU
    form) rather than a dot over the unpacked block (the reference order
    the CPU tests pin bit for bit). On the H100 above the fused form ran
    the packed BayesR sweep at 645-717 sweeps/s, the dot form at 541-557."""
    return route == "triton"


def compile_cache() -> str:
    """Persistent compile cache. JAX_COMPILATION_CACHE_DIR, when set, is
    used as it is (JAX reads it itself; nothing is set here); otherwise
    `<checkout>/.jax_cache`. Returns the directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
