"""2-process jax.distributed smoke test.

Exercises parallel.distributed.init across two real OS processes on the
CPU backend: both init against a localhost coordinator, build one global
mesh over their devices, run one sharded corrected matvec, and check the
global residual norm against a single-process reference.  This is the
closest a single host can get to the multi-host path (SURVEY section 5 distributed-backend row); skipped with the reason
logged when the environment cannot spawn the processes.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(os.environ["ANISO_TEST_DIR"]))))
import jax
jax.config.update("jax_platforms", "cpu")
from aniso_tpu.parallel import distributed

pid = int(sys.argv[1])
port = sys.argv[2]
out_path = sys.argv[3]
distributed.init(f"localhost:{port}", 2, pid)
assert distributed.is_multiprocess()
assert jax.process_count() == 2

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from aniso_tpu import SolverConfig
from aniso_tpu.solver.operator import TransportSolver
from aniso_tpu.parallel.api import make_mesh, sharded_solver

cfg = SolverConfig(domain_size=16, quad_rule=2, kernel_size=1, g=0.9,
                   sing_rule=8, np_cheb=3, dtype="float32")
solver = TransportSolver(cfg, backend="fmm")
g = solver.grid
sig = 8.0 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
solver.set_coeff(sig, sig + 0.2)
q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))

mesh = make_mesh()  # spans both processes' devices
assert mesh.devices.size == jax.device_count() >= 2
apply_fn, caches, mode_statics = sharded_solver(solver, mesh)
u = jax.device_put(q.astype(np.float32), NamedSharding(mesh, P("x", "y")))
out = apply_fn(caches, mode_statics[0], 0, u)
norm = float(jnp.linalg.norm(out))  # global reduction across processes
if pid == 0:
    with open(out_path, "w") as f:
        json.dump({"norm": norm,
                   "devices": jax.device_count(),
                   "processes": jax.process_count()}, f)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_matvec(tmp_path):
    port = _free_port()
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    out_path = tmp_path / "result.json"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # 1 CPU device per process
    env["JAX_PLATFORMS"] = "cpu"
    env["ANISO_TEST_DIR"] = os.path.abspath(__file__)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), str(port), str(out_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for pid in (0, 1)
    ]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("jax.distributed 2-process run timed out in this "
                    "environment (coordinator handshake)")
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode()[-2000:]
    rec = json.loads(out_path.read_text())
    assert rec["processes"] == 2 and rec["devices"] >= 2

    # single-process reference on this process's CPU backend
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from aniso_tpu import SolverConfig
    from aniso_tpu.solver.operator import TransportSolver

    cfg = SolverConfig(domain_size=16, quad_rule=2, kernel_size=1, g=0.9,
                       sing_rule=8, np_cheb=3, dtype="float32")
    solver = TransportSolver(cfg, backend="fmm")
    g = solver.grid
    sig = 8.0 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
    solver.set_coeff(sig, sig + 0.2)
    q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    ref = float(jnp.linalg.norm(solver.apply_mode(0, jnp.asarray(
        q, jnp.float32))))
    assert abs(rec["norm"] - ref) / ref < 1e-5, (rec["norm"], ref)
