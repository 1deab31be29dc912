"""Real multi-process execution of the distributed seam.

Everything else in the parallel stack is covered by single-process CPU
meshes; the one seam those cannot execute is the PROCESS boundary —
the `jax.distributed` coordinator handshake, cross-process
`make_array_from_process_local_data` construction, collectives spanning
processes, and per-process result read-back. This test spawns TWO
localhost worker processes (2 virtual CPU devices each → a 4-way
"space" mesh), runs `sharded_tv_admm_solve(process_local=True)` in
linear and robust (IRLS) forms, and asserts the
assembled per-process rows equal the single-process sharded solve.
BASELINE config 5's launch recipe (parallel/distributed.py docstring)
is exactly what each worker executes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

port, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]

import numpy as np
from nsol_tpu.parallel import distributed as dist

dist.initialize(coordinator_address="localhost:" + port,
                num_processes=2, process_id=pid)

import jax
assert jax.process_count() == 2
assert len(jax.devices()) == 4

from nsol_tpu.parallel.mesh import make_space_mesh, sharded_tv_admm_solve

mesh = make_space_mesh()
shape = (16, 16, 16)
rng = np.random.RandomState(0)
b_full = rng.rand(*shape).astype(np.float32)
cov = np.diag([1.0] * 3)

lo, hi = dist.process_local_slice(shape, mesh)
b_loc = b_full[lo:hi]

for tag, kw in (("linear", {}),
                ("robust", {"data_loss": "huber"})):
    x = sharded_tv_admm_solve(
        mesh, cov, b_loc, b_loc.copy(), 0.05, 0.5, iterations=2,
        iter_max=3, process_local=True, **kw)
    np.save(os.path.join(outdir, "%s_%d.npy" % (tag, pid)),
            dist.process_local_data(x))
print("WORKER_OK", pid)
"""


def test_two_process_distributed_solve(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, str(worker), port, str(i), str(tmp_path)],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "WORKER_OK" in out

    # single-process 4-way-sharded reference on this process's virtual
    # devices (same math; the multi-process run must agree bitwise-class)
    import jax

    from nsol_tpu.parallel.mesh import make_mesh, sharded_tv_admm_solve

    mesh = make_mesh((4,), ("space",), devices=jax.devices("cpu")[:4])
    shape = (16, 16, 16)
    rng = np.random.RandomState(0)
    b_full = rng.rand(*shape).astype(np.float32)
    cov = np.diag([1.0] * 3)

    for tag, kw in (("linear", {}),
                    ("robust", {"data_loss": "huber"})):
        want = np.asarray(sharded_tv_admm_solve(
            mesh, cov, b_full, b_full.copy(), 0.05, 0.5, iterations=2,
            iter_max=3, **kw))
        got = np.concatenate(
            [np.load(tmp_path / ("%s_%d.npy" % (tag, i)))
             for i in range(2)], axis=0)
        np.testing.assert_allclose(got, want.astype(np.float32),
                                   atol=1e-5, rtol=1e-5,
                                   err_msg=tag)
