"""Every contraction that can reach the device pins Precision.HIGHEST.

On an NVIDIA GPU an f32 dot or convolution at default precision may run
in TF32 (a 10-bit mantissa), which perturbs the operator by ~1e-3 and
lets GMRES "converge" on its internal estimate while the true residual
stalls.  These tests walk the jaxprs of the device programs at 16^2 --
the forward operators, the GMRES program and the set_coeff device
builders -- and require every dot_general and conv_general_dilated to
carry HIGHEST on both operands.
"""

import jax
import jax.extend.core as jcore
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from aniso_tpu import SolverConfig
from aniso_tpu.solver.operator import TransportSolver

CONTRACTIONS = ("dot_general", "conv_general_dilated")


def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        for x in v if isinstance(v, (tuple, list)) else (v,):
            if isinstance(x, jcore.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jcore.Jaxpr):
                yield x


def _contractions(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in CONTRACTIONS:
            yield eqn
        for sub in _sub_jaxprs(eqn):
            yield from _contractions(sub)


def _pinned(precision) -> bool:
    if isinstance(precision, tuple):
        return len(precision) == 2 and all(
            p == lax.Precision.HIGHEST for p in precision
        )
    return precision == lax.Precision.HIGHEST


def _solver(refine: bool, dense_cap=None, unsharded=True, monkeypatch=None):
    import aniso_tpu.fmm.smooth as S

    if monkeypatch is not None:
        monkeypatch.setattr(S, "_DENSE_E_LEVEL_CAP_BYTES", dense_cap)
        monkeypatch.setattr(S, "_UNSHARDED_BUILD", unsharded)
    cfg = SolverConfig(
        domain_size=16, quad_rule=2, kernel_size=2, g=0.5, sing_rule=4,
        np_cheb=3, dtype="float32", refine=refine, tol=1e-6,
    )
    s = TransportSolver(cfg, backend="fmm")
    g = s.grid
    sig = 8 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
    s.set_coeff(sig, sig + 0.2)
    return s


def _operator_programs(s):
    shape = (s.cfg.kernel_size,) + s.grid.nodes_x.shape
    u = jnp.zeros(shape, jnp.float32)
    args = (s._fmm_static, s._caches, s._mode_statics)
    out = {
        "forward": jax.make_jaxpr(s._forward_impl_jit)(
            *args, s._C_fwd, s.sigma_s, u),
        "rhs": jax.make_jaxpr(s._rhs_impl_jit)(*args, s._C_rhs, u),
        "gmres": jax.make_jaxpr(s._gmres_jit)(
            *args, s._C_fwd, s.sigma_s, u, u, 1e-6),
    }
    if s.cfg.refine:
        u64 = jnp.zeros(shape, jnp.float64)
        out["forward64"] = jax.make_jaxpr(s._forward_impl_jit)(
            s._fmm_static64, s._caches64, s._mode_statics64, s._C_fwd64,
            s._sigma_s64, u64)
    return out


@pytest.fixture(scope="module")
def builder_programs():
    from aniso_tpu.core.geometry import make_grid, project_field
    from aniso_tpu.fmm import smooth as S
    from aniso_tpu.fmm.structure import tree_config
    from aniso_tpu.ops.attenuation import make_line_integral, make_sigma_eval
    from aniso_tpu.ops.compat import to_local_equivalent
    from aniso_tpu.ops.fields import project

    g = make_grid(16, 2)
    tcfg = tree_config(16)
    sig = 2.0 + np.cos(2 * np.pi * g.nodes_x)
    coeffs = jnp.asarray(project_field(g, sig), jnp.float32)
    W_near = jnp.asarray(S.near_weights_np(g.deg), jnp.float32)
    leaf = tcfg.leaf_level
    W_fine = S._fine_W_device(g, 3, tcfg.box_size_squares(leaf), jnp.float32)
    # the device coarse builder's smallest level (64^2, B = 4, m2 = 8),
    # traced from shapes alone
    fn, keys = S._coarse_device_level_fn(g.deg, 3, 4, 8, g.nq)
    Ws = tuple(
        jax.ShapeDtypeStruct(
            S._coarse_offset_weight_cached(g.deg, 3, 4, di, dj)[0].shape,
            jnp.float64)
        for (di, dj) in keys
    )
    pad = jax.ShapeDtypeStruct((2 * 4 * 8 + 7 * 4,) * 2 + (g.nq,),
                               jnp.float64)
    x = jnp.zeros((), jnp.float32)
    pts = jnp.full((5,), 0.3, jnp.float32)
    return {
        "near_E": jax.make_jaxpr(S._near_E_einsum)(W_near, coeffs),
        "fine_E": jax.make_jaxpr(S._fine_E_build_jit, static_argnums=3)(
            coeffs, W_fine, x, leaf),
        "coarse_E": jax.make_jaxpr(fn)(pad, Ws, jnp.zeros((), jnp.float64)),
        "line_integral": jax.make_jaxpr(make_line_integral(g, 4))(
            coeffs, x, x, x + 0.5, x + 0.25),
        "sigma_eval": jax.make_jaxpr(make_sigma_eval(g))(coeffs, pts, pts),
        "project": jax.make_jaxpr(lambda v: project(g, v))(coeffs),
        "compat": jax.make_jaxpr(lambda c: to_local_equivalent(g, c))(coeffs),
    }


def _assert_pinned(name, closed):
    found = list(_contractions(closed.jaxpr))
    assert found, f"{name}: no contraction traced"
    loose = [
        (e.primitive.name, e.params.get("precision")) for e in found
        if not _pinned(e.params.get("precision"))
    ]
    assert not loose, f"{name}: contractions without HIGHEST: {loose}"


@pytest.fixture(scope="module")
def refined_programs():
    return _operator_programs(_solver(refine=True))


@pytest.mark.parametrize("name", ["forward", "rhs", "gmres", "forward64"])
def test_operator_programs_pin_highest(refined_programs, name):
    _assert_pinned(name, refined_programs[name])


@pytest.mark.parametrize("fallback", ["factored", "offsets"])
def test_recompute_levels_pin_highest(monkeypatch, fallback):
    """Fine levels evicted from the dense budget (factored patch @ W, or
    per-offset windows) re-form E inside the matvec."""
    s = _solver(refine=False, dense_cap=0,
                unsharded=(fallback == "offsets"), monkeypatch=monkeypatch)
    reprs = {type(v).__name__ for v in s._caches["m2l_E"].values()}
    assert "dict" in reprs, reprs
    _assert_pinned(f"forward/{fallback}",
                   _operator_programs(s)["forward"])


@pytest.mark.parametrize("name", [
    "near_E", "fine_E", "coarse_E", "line_integral", "sigma_eval",
    "project", "compat",
])
def test_builder_programs_pin_highest(builder_programs, name):
    _assert_pinned(name, builder_programs[name])
