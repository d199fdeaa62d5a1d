"""FMM correctness: operators, segment stencils, and the FMM == dense
property test (the U/V partition must reproduce the all-pairs sum up to
Chebyshev interpolation error; cf. SURVEY.md section 4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from aniso_tpu.core.config import SolverConfig
from aniso_tpu.core.geometry import make_grid
from aniso_tpu.fmm.cheb import cheb_nodes, interp_matrix, p2m_matrix
from aniso_tpu.fmm.structure import vlist_offsets, all_vlist_offsets, tree_config
from aniso_tpu.ops.segment_stencil import near_pair_weights, segment_weights
from aniso_tpu.ops.attenuation import make_line_integral
from aniso_tpu.ops.fields import project
from aniso_tpu.solver.operator import TransportSolver


def test_cheb_interpolation_exact_on_polys():
    n = 4
    x = np.linspace(-1, 1, 13)
    S = interp_matrix(n, x)          # (13, n)
    xk = cheb_nodes(n)
    for p in range(n):               # degree < n reproduced exactly
        assert np.allclose(S @ xk ** p, x ** p, atol=1e-13)


def test_vlist_partition():
    """Every well-separated pair is covered exactly once across levels."""
    L = 4  # 16x16 leaf boxes
    count = {}
    for lev in range(2, L + 1):
        m = 1 << lev
        scale = 1 << (L - lev)
        for I in range(m):
            for J in range(m):
                for (di, dj) in vlist_offsets(I % 2, J % 2):
                    SI, SJ = I + di, J + dj
                    if not (0 <= SI < m and 0 <= SJ < m):
                        continue
                    # mark all leaf pairs covered by this box pair
                    for ti in range(scale):
                        for tj in range(scale):
                            for si in range(scale):
                                for sj in range(scale):
                                    key = (I * scale + ti, J * scale + tj,
                                           SI * scale + si, SJ * scale + sj)
                                    count[key] = count.get(key, 0) + 1
    n = 1 << L
    for ti in range(n):
        for tj in range(n):
            for si in range(n):
                for sj in range(n):
                    near = max(abs(ti - si), abs(tj - sj)) <= 1
                    got = count.get((ti, tj, si, sj), 0)
                    want = 0 if near else 1
                    assert got == want, (ti, tj, si, sj, got)


def test_segment_weights_vs_generic(rng):
    """Static E stencil == generic per-pair line integral."""
    g = make_grid(8, 3)
    f = 2.0 + np.sin(2 * np.pi * g.nodes_x) * g.nodes_y
    coeffs = jnp.asarray(np.einsum("bq,ijq->ijb", g.proj, f))
    li = make_line_integral(g, max_cross=8)
    # random segments within a 3x3 patch around cell (4,4)
    for _ in range(10):
        a = rng.uniform(0, 3, size=2) + np.array([3, 3])
        b = rng.uniform(0, 3, size=2) + np.array([3, 3])
        W = segment_weights(g, a[None] - 4, b[None] - 4,
                            patch_lo=np.array([-1, -1]), patch_shape=(3, 3))
        cells = np.asarray(coeffs)[3:6, 3:6]          # (3,3,nq)
        E_stencil = g.dx * np.einsum("cdq,cdq->", W[0], cells)
        E_ref = float(li(coeffs, a[0] / 8, a[1] / 8, b[0] / 8, b[1] / 8))
        assert np.isclose(E_stencil, E_ref, rtol=1e-11, atol=1e-14)


def test_near_pair_weights_vs_generic(rng):
    g = make_grid(8, 2)
    f = 1.0 + g.nodes_x + 0.3 * g.nodes_y
    coeffs = jnp.asarray(np.einsum("bq,ijq->ijb", g.proj, f))
    li = make_line_integral(g, max_cross=2)
    W = near_pair_weights(g)
    i, j = 4, 3
    patch = np.asarray(coeffs)[i - 1 : i + 2, j - 1 : j + 2]
    dx = g.dx
    tx = (g.qx + 1) / 2
    ty = (g.qy + 1) / 2
    for a, di in enumerate((-1, 0, 1)):
        for b, dj in enumerate((-1, 0, 1)):
            for kt in range(g.nq):
                for ks in range(g.nq):
                    E_st = dx * np.einsum("cdq,cdq->", W[a, b, kt, ks], patch)
                    p_t = ((i + tx[kt]) * dx, (j + ty[kt]) * dx)
                    p_s = ((i + di + tx[ks]) * dx, (j + dj + ty[ks]) * dx)
                    E_ref = float(li(coeffs, p_s[0], p_s[1], p_t[0], p_t[1]))
                    assert np.isclose(E_st, E_ref, rtol=1e-11, atol=1e-14)


@pytest.mark.parametrize("sz", [8, 16])
def test_fmm_matches_dense(rng, sz):
    """FMM matvec == dense matvec within Chebyshev truncation error.

    sz=8 exercises the fine-level (patch-stencil) M2L path only; sz=16 also
    exercises the coarse-level (chunked generic) path at level 2 (B=4).
    """
    deg = 2
    cfg = SolverConfig(domain_size=sz, quad_rule=deg, kernel_size=2,
                       sing_rule=6, np_cheb=4)
    dense = TransportSolver(cfg, backend="dense")
    fmm = TransportSolver(cfg, backend="fmm")
    g = dense.grid
    sig_s = 4.0 + 2.0 * np.sin(2 * np.pi * g.nodes_x) * g.nodes_y
    sig_t = sig_s + 0.2
    dense.set_coeff(sig_s, sig_t)
    fmm.set_coeff(sig_s, sig_t)

    u = rng.standard_normal((sz, sz, g.nq))
    for m in range(3):
        a = np.asarray(dense.apply_mode(m, jnp.asarray(u)))
        b = np.asarray(fmm.apply_mode(m, jnp.asarray(u)))
        scale = np.abs(a).max()
        err = np.abs(a - b).max() / scale
        # np_cheb=4 black-box FMM: interpolation error ~1e-3 relative,
        # growing with mode oscillation (cos(m theta)); convergence in
        # np_cheb is asserted separately below
        assert err < 6e-3, (m, err)


def test_fmm_convergence_with_np(rng):
    """FMM error vs np_cheb.

    With a *globally* polynomial sigma_t (here: linear, exactly representable
    at deg=2) E(p, q) is smooth in the endpoints and black-box Chebyshev
    interpolation converges spectrally.  With per-cell sigma_t the kernel is
    only piecewise smooth and convergence is algebraic -- an inherent
    property of the reference scheme too (its bbfmm interpolates the same
    kernel, bbfmm.h:782-804); we assert monotone decrease there.
    """
    sz, deg = 8, 2
    u = None
    errs_smooth, errs_pw = [], []
    for np_cheb in (3, 5, 7):
        cfg = SolverConfig(domain_size=sz, quad_rule=deg, kernel_size=1,
                           sing_rule=6, np_cheb=np_cheb)
        for errs, sig_fn in (
            (errs_smooth, lambda x, y: 2.0 + x + 0.5 * y),
            (errs_pw, lambda x, y: 4.0 + 2.0 * np.sin(2 * np.pi * x) * y),
        ):
            dense = TransportSolver(cfg, backend="dense")
            fmm = TransportSolver(cfg, backend="fmm")
            g = dense.grid
            sig_t = sig_fn(g.nodes_x, g.nodes_y) + 0.2
            dense.set_coeff(sig_t, sig_t)
            fmm.set_coeff(sig_t, sig_t)
            if u is None:
                u = rng.standard_normal((sz, sz, g.nq))
            a = np.asarray(dense.apply_mode(0, jnp.asarray(u)))
            b = np.asarray(fmm.apply_mode(0, jnp.asarray(u)))
            errs.append(np.abs(a - b).max() / np.abs(a).max())
    # spectral for smooth sigma
    assert errs_smooth[2] < errs_smooth[0] * 1e-2, errs_smooth
    assert errs_smooth[2] < 2e-6, errs_smooth
    # monotone decrease for piecewise sigma
    assert errs_pw[2] < errs_pw[1] < errs_pw[0], errs_pw


def test_fmm_end_to_end_solve(rng):
    sz, deg = 8, 2
    cfg = SolverConfig(domain_size=sz, quad_rule=deg, kernel_size=1, g=0.5,
                       sing_rule=6, np_cheb=5, tol=1e-9, restart=40,
                       max_iter=200)
    fmm = TransportSolver(cfg, backend="fmm")
    g = fmm.grid
    sig_s = 4.0 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
    sig_t = sig_s + 0.2
    fmm.set_coeff(sig_s, sig_t)
    q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    res = fmm.solve(q)
    assert bool(res.converged)
    b = fmm.rhs(jnp.asarray(q)[None])
    r = np.asarray(fmm.forward(res.x)) - np.asarray(b)
    rel = np.linalg.norm(r) / np.linalg.norm(np.asarray(b))
    assert rel < 5e-9, rel


def test_m2l_translate_chunked_matches_unchunked(monkeypatch):
    """Row-chunked streaming translate (512^2 memory cap) is exact."""
    import aniso_tpu.fmm.apply as A

    rng = np.random.default_rng(3)
    m2, r, ob = 8, 4, 12 * 4
    P = r * ob
    E = jnp.asarray(rng.random((4, m2, m2, P)))
    cosr = jnp.asarray(rng.random((4, P)))
    g = jnp.asarray(rng.random((4, m2, m2, ob)))
    ref = np.asarray(A._m2l_translate(E, cosr, g))
    monkeypatch.setattr(A, "_M2L_TRANSIENT_CAP_BYTES", 1)
    out = np.asarray(A._m2l_translate(E, cosr, g))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("cap", [0])
def test_factored_fine_E_matches_dense(monkeypatch, cap):
    """Factored (patch, W) fine-level storage reproduces the dense E path.

    E is exactly linear in the local sigma_t patch (fmm.smooth.
    build_m2l_patch_fine), so forcing every fine level to the factored
    representation (dense_cap_bytes=0) must leave the corrected matvec
    unchanged to rounding."""
    import aniso_tpu.fmm.smooth as S

    sz, deg = 16, 2
    cfg = SolverConfig(
        domain_size=sz, quad_rule=deg, kernel_size=2, g=0.5,
        sing_rule=6, np_cheb=4, dtype="float64",
    )
    rng = np.random.default_rng(11)
    solver = TransportSolver(cfg, backend="fmm")
    g = solver.grid
    sig_s = 1.0 + rng.random(g.nodes_x.shape)
    sig_t = sig_s + 0.3

    solver.set_coeff(sig_s, sig_t)
    u = rng.random(g.nodes_x.shape)
    ref = [np.asarray(solver.apply_mode(m, jnp.asarray(u))) for m in (0, 1)]
    # dense-form leaf levels are factored when above the (patched) cap
    assert all(
        not isinstance(v, dict) for v in solver._caches["m2l_E"].values()
    )

    monkeypatch.setattr(S, "_DENSE_E_LEVEL_CAP_BYTES", cap)
    monkeypatch.setattr(S, "_UNSHARDED_BUILD", False)  # pin factored
    solver2 = TransportSolver(cfg, backend="fmm")
    solver2.set_coeff(sig_s, sig_t)
    assert any(
        isinstance(v, dict) for v in solver2._caches["m2l_E"].values()
    )
    for m in (0, 1):
        out = np.asarray(solver2.apply_mode(m, jnp.asarray(u)))
        np.testing.assert_allclose(out, ref[m], rtol=1e-12, atol=1e-13)


def test_m2l_translate_factored_chunked(monkeypatch):
    """Factored translate under row-chunk streaming == unchunked dense."""
    import aniso_tpu.fmm.apply as A

    rng = np.random.default_rng(7)
    m2, r, Q = 8, 4, 12
    ob = 27 * r
    P = r * ob
    patch = jnp.asarray(rng.random((4, m2, m2, Q)))
    W = jnp.asarray(rng.random((4, Q, P)))
    E = jnp.einsum("cxyq,cqp->cxyp", patch, W)
    cosr = jnp.asarray(rng.random((4, P)))
    g = jnp.asarray(rng.random((4, m2, m2, ob)))
    ref = np.asarray(A._m2l_translate(E, cosr, g))
    out = np.asarray(A._m2l_translate({"patch": patch, "W": W}, cosr, g))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
    monkeypatch.setattr(A, "_M2L_TRANSIENT_CAP_BYTES", 1)
    out2 = np.asarray(A._m2l_translate({"patch": patch, "W": W}, cosr, g))
    np.testing.assert_allclose(out2, ref, rtol=1e-12, atol=1e-12)


def test_offsets_fine_E_matches_dense():
    """The per-offset virtual representation (fmm.smooth.
    build_m2l_offsets_fine + fmm.apply._m2l_translate_offsets) reproduces
    the dense E path: each canonical (class, offset) block re-formed from
    bounding-box windows is the same exact quadrature, and the mirror
    reuse (exp(-E) transposed) must be exact by the line-integral symmetry
    E(a->b) = E(b->a)."""
    import jax
    import aniso_tpu.fmm.smooth as S
    from aniso_tpu.fmm import apply as A

    sz, deg = 16, 2
    cfg = SolverConfig(
        domain_size=sz, quad_rule=deg, kernel_size=2, g=0.5,
        sing_rule=6, np_cheb=4, dtype="float64",
    )
    rng = np.random.default_rng(11)
    solver = TransportSolver(cfg, backend="fmm")
    g = solver.grid
    sig_s = 1.0 + rng.random(g.nodes_x.shape)
    solver.set_coeff(sig_s, sig_s + 0.3)
    u = rng.random(g.nodes_x.shape)
    ref = [np.asarray(solver.apply_mode(m, jnp.asarray(u))) for m in (0, 1)]

    coeffs_dev = jnp.asarray(solver._coeffs_np, dtype=jnp.float64)
    virt = dict(solver._caches)
    virt["m2l_E"] = S.build_m2l_E(
        g, solver._tcfg, cfg.np_cheb, coeffs_dev, dtype=jnp.float64,
        coeffs_np=solver._coeffs_np, budget_bytes=0,
        fine_fallback="offsets",
    )
    assert any(
        isinstance(v, dict) and "Wo" in v for v in virt["m2l_E"].values()
    )
    virt["coeffs"] = coeffs_dev
    leaf = solver._tcfg.leaf_level
    apply_jit = jax.jit(
        lambda c, ms, u, m: A.fmm_apply_mode(
            leaf, solver._fmm_static, c, ms, m, u
        ),
        static_argnums=(3,),
    )
    for m in (0, 1):
        out = np.asarray(apply_jit(virt, solver._mode_statics[m], u, m))
        np.testing.assert_allclose(out, ref[m], rtol=1e-12, atol=1e-13)


def test_offsets_multimode_forward_matches_dense():
    """fmm_apply_all_modes over per-offset levels (one E re-form + exp
    shared by every mode, _m2l_translate_offsets_multi) == the dense-cache
    multi-mode forward."""
    import jax
    import aniso_tpu.fmm.smooth as S

    cfg = SolverConfig(
        domain_size=16, quad_rule=2, kernel_size=2, g=0.5,
        sing_rule=6, np_cheb=4, dtype="float64",
    )
    rng = np.random.default_rng(3)
    s = TransportSolver(cfg, backend="fmm")
    g = s.grid
    sig = 1.0 + rng.random(g.nodes_x.shape)
    s.set_coeff(sig, sig + 0.3)
    u = rng.random((2,) + g.nodes_x.shape)
    ref = np.asarray(s.forward(jnp.asarray(u)))

    coeffs_dev = jnp.asarray(s._coeffs_np, dtype=jnp.float64)
    s._caches = dict(s._caches)
    s._caches["m2l_E"] = S.build_m2l_E(
        g, s._tcfg, cfg.np_cheb, coeffs_dev, dtype=jnp.float64,
        coeffs_np=s._coeffs_np, budget_bytes=0, fine_fallback="offsets",
    )
    s._caches["coeffs"] = coeffs_dev
    out = np.asarray(s.forward(jnp.asarray(u)))
    err = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert err < 1e-12, err
