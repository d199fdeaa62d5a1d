"""Coarse-level M2L E assembly: dgemm restructuring + symmetry mirror.

The production path (fmm.smooth.build_m2l_E_coarse_np) must reproduce the
brute-force all-pairs oracle (build_m2l_E_coarse_oracle_np) exactly on
every observable entry -- i.e. every (box, offset) pair whose source box
lies inside the domain (out-of-domain sources are zero-padded in the
V-list gather, so their E values are never observable).
"""

import numpy as np
import pytest

from aniso_tpu.core.geometry import make_grid, project_field
from aniso_tpu.fmm import smooth
from aniso_tpu.fmm.structure import tree_config, vlist_offsets


def _observable_max_diff(E_a, E_b, m2, r):
    """Max |E_a - E_b| over entries with in-domain source boxes."""
    A = E_a.reshape(4, m2, m2, r, 27, r)
    B6 = E_b.reshape(4, m2, m2, r, 27, r)
    worst = 0.0
    for px in (0, 1):
        for py in (0, 1):
            c = 2 * px + py
            for o, (di, dj) in enumerate(vlist_offsets(px, py)):
                # in-domain source boxes: 0 <= 2x+px+di < 2*m2
                xs = [x for x in range(m2) if 0 <= 2 * x + px + di < 2 * m2]
                ys = [y for y in range(m2) if 0 <= 2 * y + py + dj < 2 * m2]
                if not xs or not ys:
                    continue
                sub = np.ix_([c], xs, ys)
                d = np.abs(A[sub][..., :, o, :] - B6[sub][..., :, o, :])
                worst = max(worst, float(d.max()))
    return worst


def test_mirror_table_is_involution():
    tab = smooth.coarse_mirror_table(4)
    by_key = {(c, o): (canonical, c2, o2, sx, sy)
              for (c, o, canonical, c2, o2, sx, sy) in tab}
    n_canon = 0
    for (c, o), (canonical, c2, o2, sx, sy) in by_key.items():
        mirror = by_key[(c2, o2)]
        assert mirror[1:3] == (c, o), "mirror of mirror returns"
        assert mirror[0] != canonical, "exactly one of each pair canonical"
        assert (mirror[3], mirror[4]) == (-sx, -sy)
        n_canon += canonical
    assert n_canon == len(by_key) // 2


@pytest.mark.parametrize("sz,level", [(32, 2), (64, 4)])
def test_coarse_e_matches_oracle(sz, level, rng):
    """32^2 lv2 (B=8, m2=2): canonical per-pair + mirror; 64^2 lv4
    (B=4, m2=8): the per-offset dgemm path."""
    g = make_grid(sz, 3)
    tcfg = tree_config(sz)
    sig = 2.0 + rng.uniform(0.0, 3.0, g.nodes_x.shape)
    coeffs = project_field(g, np.asarray(sig, np.float64))
    E_new = smooth.build_m2l_E_coarse_np(g, tcfg, level, 4, None,
                                         coeffs_np=coeffs)
    E_ref = smooth.build_m2l_E_coarse_oracle_np(g, tcfg, level, 4, None,
                                                coeffs_np=coeffs)
    m2 = tcfg.boxes(level) // 2
    worst = _observable_max_diff(E_new, E_ref, m2, 16)
    assert worst < 1e-11, worst


@pytest.mark.parametrize("sz,level", [(64, 4)])
def test_coarse_e_device_matches_host(sz, level, rng):
    """The device coarse builder (one jitted f64 program per level;
    production path when x64 is on) must reproduce the host dgemm
    restructuring to f64 roundoff on every entry -- including the
    mirrored blocks, whose zero off-plane rows are part of the layout."""
    g = make_grid(sz, 3)
    tcfg = tree_config(sz)
    assert smooth._coarse_dgemm_eligible(g, tcfg, level, 4)
    sig = 2.0 + rng.uniform(0.0, 3.0, g.nodes_x.shape)
    coeffs = project_field(g, np.asarray(sig, np.float64))
    E_dev = np.asarray(
        smooth.build_m2l_E_coarse_device(g, tcfg, level, 4, coeffs)
    )
    E_host = smooth.build_m2l_E_coarse_np(g, tcfg, level, 4, None,
                                          coeffs_np=coeffs)
    np.testing.assert_allclose(E_dev, E_host, rtol=1e-12, atol=1e-13)


def test_coarse_all_mixes_device_and_host(rng):
    """build_m2l_E_coarse_all routes dgemm-eligible levels to the device
    and per-pair levels to the host, and both match the all-host path."""
    import jax

    g = make_grid(64, 3)
    tcfg = tree_config(64)
    sig = 2.0 + rng.uniform(0.0, 3.0, g.nodes_x.shape)
    coeffs = project_field(g, np.asarray(sig, np.float64))
    mixed = smooth.build_m2l_E_coarse_all(g, tcfg, 4, coeffs)
    ref = smooth.build_m2l_E_coarse_all_np(g, tcfg, 4, coeffs)
    assert set(mixed) == set(ref)
    kinds = {lv: isinstance(v, jax.Array) for lv, v in mixed.items()}
    assert any(kinds.values()) and not all(kinds.values()), kinds
    for lv in mixed:
        np.testing.assert_allclose(
            np.asarray(mixed[lv]), ref[lv], rtol=1e-12, atol=1e-13
        )


def test_dense_budget_allocates_coarsest_first(monkeypatch, rng):
    """The HBM budget admits dense levels coarsest-first; the leaf is the
    first to fall back to the factored form, and a zero budget factors
    every fine level."""
    import jax.numpy as jnp
    from aniso_tpu.fmm import smooth

    g = make_grid(16, 2)
    tcfg = tree_config(16)
    sig = 2.0 + rng.uniform(0.0, 1.0, g.nodes_x.shape)
    coeffs = project_field(g, np.asarray(sig, np.float64))
    cdev = jnp.asarray(coeffs, jnp.float32)

    def reprs(budget):
        cache = smooth.build_m2l_E(g, tcfg, 3, cdev, dtype=jnp.float32,
                                   coeffs_np=coeffs, budget_bytes=budget)
        return {lv: ("factored" if isinstance(v, dict) else "dense")
                for lv, v in cache.items()}

    full = reprs(None)
    assert set(full.values()) == {"dense"}

    r = 9
    lvl_bytes = {}
    for lv in range(2, tcfg.leaf_level + 1):
        m2 = tcfg.boxes(lv) // 2
        if tcfg.box_size_squares(lv) <= 2:
            lvl_bytes[lv] = smooth.fine_dense_level_bytes(m2, 3, 4)
        else:
            lvl_bytes[lv] = 4 * m2 * m2 * (r * 27 * r) * 4
    # the budget counts true bytes: exactly the arrays it admits
    cache = smooth.build_m2l_E(g, tcfg, 3, cdev, dtype=jnp.float32,
                               coeffs_np=coeffs, budget_bytes=None)
    assert smooth.m2l_cache_bytes(cache) == sum(lvl_bytes.values())
    coarse = sum(b for lv, b in lvl_bytes.items()
                 if tcfg.box_size_squares(lv) > 2)
    # enough for everything but the leaf
    partial = reprs(coarse + lvl_bytes[3] + lvl_bytes[4] - 1)
    assert partial[4] == "factored" and partial[3] == "dense", partial
    starved = reprs(0)
    assert starved[3] == "factored" and starved[4] == "factored", starved


class _Device:
    """Stand-in for a jax device: platform, kind and memory_stats()."""

    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_budget_reads_bytes_limit():
    gpu = _Device("gpu", {"bytes_limit": 60 << 30, "bytes_in_use": 0})
    assert smooth.device_memory_budget(gpu) == 60 << 30
    # the CPU backend reports no stats: the named CPU test budget
    assert smooth.device_memory_budget(_Device("cpu", None)) == \
        smooth.CPU_TEST_BUDGET_BYTES
    with pytest.raises(RuntimeError, match="bytes_limit"):
        smooth.device_memory_budget(_Device("gpu", {"bytes_in_use": 0}))
    with pytest.raises(RuntimeError, match="bytes_limit"):
        smooth.device_memory_budget(_Device("gpu", None))


@pytest.mark.parametrize("room, leaf, mid", [
    ("all", "dense", "dense"),
    ("all_but_leaf", "per-offset", "dense"),
    ("none", "per-offset", "per-offset"),
])
def test_solver_budget_from_bytes_limit(monkeypatch, room, leaf, mid):
    """TransportSolver sizes its dense E levels from the device's
    bytes_limit minus everything else resident: a level that does not
    fit takes the per-offset recompute form (single device)."""
    from aniso_tpu import SolverConfig
    from aniso_tpu.solver.operator import TransportSolver

    cfg = SolverConfig(domain_size=16, quad_rule=2, kernel_size=1, g=0.5,
                       sing_rule=4, np_cheb=3, dtype="float32")
    s = TransportSolver(cfg, backend="fmm")
    tcfg = s._tcfg
    fine = {lv: smooth.fine_dense_level_bytes(tcfg.boxes(lv) // 2, 3, 4)
            for lv in (3, 4)}
    coarse = smooth.coarse_dense_bytes(tcfg, 3, 4)
    limit = s._resident_bytes() + {
        "all": coarse + fine[3] + fine[4],
        "all_but_leaf": coarse + fine[3] + fine[4] - 1,
        "none": 0,
    }[room]
    real = smooth.device_memory_budget
    monkeypatch.setattr(
        smooth, "device_memory_budget",
        lambda device=None: real(_Device("gpu", {"bytes_limit": limit})),
    )
    sig = np.full_like(s.grid.nodes_x, 5.0)
    s.set_coeff(sig, sig + 0.2)
    E = s._caches["m2l_E"]

    def kind(v):
        return "per-offset" if isinstance(v, dict) else "dense"

    assert (kind(E[4]), kind(E[3])) == (leaf, mid)
    assert kind(E[2]) == "dense"          # coarse levels are always dense
