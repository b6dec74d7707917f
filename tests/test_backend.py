"""The route module (nextgp_tpu/backend.py): what runs where, asked with an
explicit platform so every branch is checked on the CPU."""
import os

import jax
import numpy as np
import pytest

import nextgp_tpu as ng
from nextgp_tpu import backend


@pytest.mark.parametrize("plat,route", [("gpu", "triton"), ("cpu", "xla")])
def test_kernel_route_by_platform(plat, route):
    assert backend.kernel_route(plat) == route
    # the platform's own route resolves without the interpreter
    assert backend.resolve_route(None, platform_=plat) == route
    assert backend.default_pack(plat) == (plat == "gpu")


@pytest.mark.parametrize("route,interpret,plat,ok", [
    ("triton", False, "gpu", True),
    ("xla", False, "gpu", True),
    ("xla", False, "cpu", True),
    ("triton", True, "cpu", True),   # explicit interpreter: allowed
    ("triton", False, "cpu", False),  # no GPU, no interpreter: refuse
])
def test_resolve_route_never_falls_back(route, interpret, plat, ok):
    if ok:
        assert backend.resolve_route(route, interpret, plat) == route
    else:
        with pytest.raises(RuntimeError, match="needs a GPU"):
            backend.resolve_route(route, interpret, plat)


def test_resolve_route_unknown():
    with pytest.raises(ValueError, match="unknown kernel route"):
        backend.resolve_route("mosaic", platform_="gpu")


def _tiny_spec(rng, block=16):
    n, p = 30, 48
    g = rng.integers(0, 3, (n, p)).astype(float)
    return ng.ModelSpec(
        y=rng.normal(0, 1, n), fixed=[ng.FixedTerm("int", np.ones(n))],
        markers=[ng.MarkerTerm("M", ng.from_array(g), ng.BayesC(0.1, 0.05))],
        block_size=block)


def test_assemble_routes(rng):
    """assemble takes its route from the module: on the CPU the plain scan
    with dot passes; the Triton route only with the interpreter asked for,
    and only with power-of-two blocks (Triton block shapes)."""
    plan, _ = ng.assemble(_tiny_spec(rng))
    mp = plan.markers[0]
    assert (mp.route, mp.interpret, mp.fused_passes, mp.packed) == ("xla", False, False, False)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        ng.assemble(_tiny_spec(rng), route="triton")
    plan, _ = ng.assemble(_tiny_spec(rng), route="triton", interpret=True)
    mp = plan.markers[0]
    assert (mp.route, mp.interpret, mp.fused_passes) == ("triton", True, True)
    with pytest.raises(ValueError, match="power-of-two"):
        ng.assemble(_tiny_spec(rng, block=12), route="triton", interpret=True)


def test_compile_cache_rule(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is honoured as set (nothing set in code);
    without it the cache is <checkout>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(backend.__file__)))
    assert backend.compile_cache() == os.path.join(checkout, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == os.path.join(checkout, ".jax_cache")
