"""Checks that need an NVIDIA GPU; they skip elsewhere (tests/conftest.py
says how to run them on a card)."""

import importlib.util
import os

import pytest

from aniso_tpu import SolverConfig
from aniso_tpu.solver.operator import TransportSolver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_forward_runs_true_f32_on_gpu(gpu):
    """The compiled f32 forward operator matches its f64 twin to f32
    rounding; a TF32 contraction anywhere on the path would show ~1e-3."""
    smoke = _chip_smoke()
    cfg = SolverConfig(domain_size=64, quad_rule=3, kernel_size=1, g=0.5,
                       sing_rule=8, np_cheb=4, dtype="float32", refine=True,
                       tol=1e-8)
    s = TransportSolver(cfg, backend="fmm")
    s.set_coeff(*smoke.default_sigma(s.grid))
    assert s.sigma_s.devices() == {gpu}
    gap = smoke.operator_gap(s, seed=0)
    assert gap < smoke.OPERATOR_GAP_GATE, gap
