"""Two-process ``torch.distributed`` test of the port's sharding layer
(modelled on tests/test_multihost.py).

Two CPU processes call ``multihost_init`` (a gloo process group over
tcp://127.0.0.1), each with a one-entry mesh and its own two rows of a
four-row float64 batch whose last row is padding (``n_valid`` = 3).  The
global statistics of ``chomp_solve_sharded`` (the summed cost trace and
the mean final cost) and of ``solve_sharded`` (the mean final cost) must be
the all-reduced ones over both processes with the padded row left out: the
JAX package's unsharded ``chomp_solve`` and ``gpmp2_solve`` on the three
valid rows in float64, to 1e-8, and the port's own unsharded solvers, to
1e-10.

With two or more CUDA cards the same two processes join an nccl group
(``multihost_init``'s default there), each pinned to its own card, and
all-reduce the masked mean of per-row statistics held on that card.
"""
import json
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

_SETUP = r"""
import torch
from torch_robotics_tpu_torch.envs import EnvDense2D
from torch_robotics_tpu_torch.robots import RobotPointMass
from torch_robotics_tpu_torch.solve import (CHOMPParams, GPMP2Params,
                                            gpmp2_init_trajs)
from torch_robotics_tpu_torch.tasks import PlanningTask

task = PlanningTask(env=EnvDense2D(device="cpu"),
                    robot=RobotPointMass.create(device="cpu"),
                    obstacle_cutoff_margin=0.01)
START = torch.tensor([-0.9, -0.9, 0.0, 0.0])
GOAL = torch.tensor([0.9, 0.9, 0.0, 0.0])
GP = GPMP2Params(n_support_points=16, dt=0.04, opt_iters=4, sigma_start=1e-4,
                 sigma_gp=1e-2, sigma_goal_prior=1e-4, sigma_coll=1e-3,
                 step_size=0.5, sigma_gp_init=0.05)
CHOMP = CHOMPParams(n_support_points=16, dt=0.04, opt_iters=5,
                    sigma_coll=1e-2)
theta = gpmp2_init_trajs(torch.Generator().manual_seed(1), GP, START, GOAL,
                         num_samples=3).double()
theta = torch.cat([theta, theta[-1:]])        # row 3 pads the batch
START, GOAL = START.double(), GOAL.double()
"""

_WORKER = _SETUP + r"""
import json, sys
import torch.distributed as dist
from torch_robotics_tpu_torch.parallel import (chomp_solve_sharded,
                                               make_mesh, multihost_init,
                                               solve_sharded)
pid, port = int(sys.argv[1]), sys.argv[2]
multihost_init(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
               process_id=pid, backend="gloo")
assert dist.get_world_size() == 2 and dist.get_rank() == pid
assert dist.get_backend() == "gloo"
mesh = make_mesh(devices=["cpu"])
local = theta[2 * pid:2 * pid + 2]
res, gmean = chomp_solve_sharded(task.collision_residuals, local, START,
                                 GOAL, CHOMP, mesh, n_valid=3)
_, gp_mean = solve_sharded(task.collision_residuals, local, START, GOAL, GP,
                           mesh, n_valid=3)
print("RESULT " + json.dumps({"pid": pid, "trace": res.cost_trace.tolist(),
                              "chomp_mean": float(gmean),
                              "gpmp2_mean": float(gp_mean)}))
dist.destroy_process_group()
"""

_CUDA_WORKER = r"""
import json, sys
import torch
import torch.distributed as dist
from torch_robotics_tpu_torch.parallel import make_mesh, multihost_init
from torch_robotics_tpu_torch.parallel.mesh import _masked_mean
pid, port = int(sys.argv[1]), sys.argv[2]
multihost_init(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
               process_id=pid)
assert dist.get_backend() == "nccl" and torch.cuda.current_device() == pid
mesh = make_mesh(devices=[torch.cuda.current_device()])
rows = torch.tensor([1.0, 2.0], device=mesh[0]) + 2 * pid
mean = _masked_mean([rows], 3, mesh)
assert mean.device == mesh[0]
print("RESULT " + json.dumps({"pid": pid, "mean": float(mean)}))
dist.destroy_process_group()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_two(tmp_path, source, extra_env=()):
    """Run ``source`` as ranks 0 and 1 -> each rank's RESULT object."""
    port = _free_port()
    repo = str(pathlib.Path(__file__).resolve().parents[1])
    worker = tmp_path / "worker.py"
    worker.write_text(source)
    env = {"PYTHONPATH": repo, "PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "OMP_NUM_THREADS": "1", **dict(extra_env)}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=repo) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed test timed out")
        outs.append(out.decode())
    results = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out
        results.append(json.loads(line[-1][len("RESULT "):]))
    return results


def test_two_process_all_reduced_statistics(tmp_path):
    results = _run_two(tmp_path, _WORKER)

    import jax
    import jax.numpy as jnp

    from torch_robotics_tpu.envs import EnvDense2D as JEnvDense2D
    from torch_robotics_tpu.robots import RobotPointMass as JRobotPointMass
    from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
    from torch_robotics_tpu.solve import gpmp2_solve as jax_gpmp2_solve
    from torch_robotics_tpu.solve.chomp import CHOMPParams as JCHOMPParams
    from torch_robotics_tpu.solve.chomp import chomp_solve as jax_chomp_solve
    from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
    from torch_robotics_tpu_torch.solve import chomp_solve, gpmp2_solve
    ns = {}
    exec(_SETUP, ns)
    valid = ns["theta"][:3]
    jtask = JPlanningTask(env=JEnvDense2D(), robot=JRobotPointMass.create(),
                          obstacle_cutoff_margin=0.01)
    with jax.enable_x64(True):
        args = (jnp.asarray(valid.numpy()), jnp.asarray(ns["START"].numpy()),
                jnp.asarray(ns["GOAL"].numpy()))
        jref = jax_chomp_solve(jtask.collision_residuals, *args,
                               JCHOMPParams(**ns["CHOMP"].__dict__),
                               per_problem_trace=True)
        jtrace = np.asarray(jref.cost_trace).sum(axis=1)
        jchomp_mean = float(np.asarray(jref.cost_trace)[-1].mean())
        jgp_mean = float(np.asarray(jax_gpmp2_solve(
            jtask.collision_residuals, *args,
            JGPMP2Params(**ns["GP"].__dict__)).costs).mean())
    ref = chomp_solve(ns["task"].collision_residuals, valid, ns["START"],
                      ns["GOAL"], ns["CHOMP"], per_problem_trace=True)
    trace = ref.cost_trace.sum(dim=1).numpy()
    chomp_mean = float(ref.cost_trace[-1].mean())
    gp_mean = float(gpmp2_solve(ns["task"].collision_residuals, valid,
                                ns["START"], ns["GOAL"],
                                ns["GP"]).costs.mean())
    for r in results:
        np.testing.assert_allclose(r["trace"], jtrace, rtol=1e-8)
        assert r["chomp_mean"] == pytest.approx(jchomp_mean, rel=1e-8)
        assert r["gpmp2_mean"] == pytest.approx(jgp_mean, rel=1e-8)
        np.testing.assert_allclose(r["trace"], trace, rtol=1e-10)
        assert r["chomp_mean"] == pytest.approx(chomp_mean, rel=1e-10)
        assert r["gpmp2_mean"] == pytest.approx(gp_mean, rel=1e-10)


@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="an nccl group of two processes needs two CUDA "
                           "cards, one for each")
def test_two_process_nccl_pins_each_rank_to_its_card(tmp_path):
    """Rank r holds rows (1, 2) + 2 r on cuda:r; n_valid = 3 leaves rank
    1's second row out: the mean of 1, 2 and 3."""
    results = _run_two(tmp_path, _CUDA_WORKER)
    assert [r["mean"] for r in results] == [2.0, 2.0]
