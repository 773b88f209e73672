"""The port's runnable examples (torch_robotics_tpu_torch/examples/): each
``main`` runs on the CPU at a small size and returns finite numbers of
the kinds its JAX counterpart prints; importing them imports neither JAX
nor the JAX package, and each defaults to the card (it raises where CUDA
is missing rather than falling back to the CPU)."""
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_robotics_tpu_torch.examples import (ilqr_panda, mpc_panda,
                                               multi_robot_mpc,
                                               planning_point_mass)

ROOT = Path(__file__).resolve().parents[1]
SMALL = {
    "mpc_panda": (mpc_panda, dict(batch=4, n_steps=3, horizon=8)),
    "ilqr_panda": (ilqr_panda, dict(batch=4, horizon=8, opt_iters=3,
                                    track=True, n_exec=2)),
    "multi_robot_mpc": (multi_robot_mpc, dict(batch=2, n_steps=2, horizon=8,
                                              max_samples=8192)),
    "planning_point_mass": (planning_point_mass, dict(num_samples=8,
                                                      opt_iters=10)),
}
KEYS = {
    "mpc_panda": {"mean_final_dist", "fraction_contact_free",
                  "executed_free", "tracking_error"},
    "ilqr_panda": {"feasibility_err", "mean_final_goal_dist",
                   "fraction_free", "track_median_goal_dist"},
    "multi_robot_mpc": {"mean_start_dist", "mean_final_dist",
                        "fraction_contact_free"},
    "planning_point_mass": {"fraction_free", "collision_intensity",
                            "success", "path_length", "smoothness"},
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_main_runs_on_the_cpu(name):
    module, kw = SMALL[name]
    out = module.main("cpu", **kw)
    assert KEYS[name] <= set(out)
    for key, value in out.items():
        assert isinstance(value, (int, float)) and math.isfinite(value), key
    for key in ("fraction_free", "fraction_contact_free"):
        if key in out:
            assert 0.0 <= out[key] <= 1.0
    if name == "ilqr_panda":
        assert out["feasibility_err"] < 1e-4


def test_examples_import_no_jax():
    code = ("import sys\n"
            "import torch_robotics_tpu_torch.examples.mpc_panda\n"
            "import torch_robotics_tpu_torch.examples.ilqr_panda\n"
            "import torch_robotics_tpu_torch.examples.multi_robot_mpc\n"
            "import torch_robotics_tpu_torch.examples.planning_point_mass\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'torch_robotics_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("name", sorted(SMALL))
def test_main_defaults_to_the_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SMALL[name][0].main()


def compare_multi_robot_mpc(batch: int = 4, n_steps: int = 30) -> dict:
    """``multi_robot_mpc``'s problem on its own draw (the port's generator,
    seed 0) through the port's and the JAX package's MPC on the CPU ->
    both final goal distances and contact-free shares, and the largest gap
    of the executed states."""
    import jax.numpy as jnp
    import numpy as np
    from torch_robotics_tpu.core import z_rot as jz_rot
    from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
    from torch_robotics_tpu.robots import MultiRobot as JMultiRobot
    from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
    from torch_robotics_tpu.robots import RobotUR10 as JRobotUR10
    from torch_robotics_tpu.solve import GPMP2Params as JGPMP2Params
    from torch_robotics_tpu.solve.mpc import MPCParams as JMPCParams
    from torch_robotics_tpu.solve.mpc import mpc_rollout as jax_mpc_rollout
    from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
    from torch_robotics_tpu_torch.solve import (GPMP2Params, MPCParams,
                                                mpc_rollout)
    ex = multi_robot_mpc
    robot = ex.MultiRobot.create(
        [ex.RobotPanda.create(device="cpu"), ex.RobotPanda.create(
            device="cpu"), ex.RobotUR10(device="cpu")],
        [(ex.z_rot(a, device="cpu"), torch.tensor(t)) for a, t in (
            (0.0, [0.2, 0.72, 0.0]), (math.pi, [0.2, -0.72, 0.0]),
            (0.0, [-0.75, 0.0, 0.0]))])
    task = ex.PlanningTask(env=ex.EnvSpheres3D(device="cpu"), robot=robot,
                           obstacle_cutoff_margin=0.02)
    gen = torch.Generator().manual_seed(0)
    q0, _ = task.random_coll_free_q(gen, n_samples=batch,
                                    max_samples=131072)
    qg, _ = task.random_coll_free_q(gen, n_samples=batch,
                                    max_samples=131072)
    start = torch.cat([q0, torch.zeros_like(q0)], -1)
    goal = torch.cat([qg, torch.zeros_like(qg)], -1)
    gp = dict(n_support_points=32, dt=0.05, sigma_start=1e-3, sigma_gp=1e-1,
              sigma_goal_prior=1e-3, sigma_coll=1e-3, step_size=0.7)
    xs, info = mpc_rollout(task.collision_residuals, start, goal,
                           MPCParams(gpmp2=GPMP2Params(**gp),
                                     iters_per_step=2), n_steps)
    jrobot = JMultiRobot.create(
        [JRobotPanda.create(), JRobotPanda.create(), JRobotUR10()],
        [(jnp.eye(3), jnp.array([0.2, 0.72, 0.0])),
         (jz_rot(jnp.array(jnp.pi)), jnp.array([0.2, -0.72, 0.0])),
         (jnp.eye(3), jnp.array([-0.75, 0.0, 0.0]))])
    jtask = JPlanningTask(env=JEnvSpheres3D(), robot=jrobot,
                          obstacle_cutoff_margin=0.02)
    jxs, jinfo = jax_mpc_rollout(
        jtask.collision_residuals, jnp.asarray(start.numpy()),
        jnp.asarray(goal.numpy()),
        JMPCParams(gpmp2=JGPMP2Params(**gp), iters_per_step=2), n_steps)
    free = 1.0 - float(task.compute_collision(xs, margin=0.0).any(-1)
                       .float().mean())
    jfree = 1.0 - float(jnp.mean(jnp.any(
        jtask.compute_collision(jxs, margin=0.0), axis=-1)))
    return dict(batch=batch, steps=n_steps,
                port_final_dist=info["dist_to_goal"][-1].tolist(),
                jax_final_dist=np.asarray(jinfo["dist_to_goal"][-1]).tolist(),
                port_contact_free=free, jax_contact_free=jfree,
                max_abs_state_gap=float(np.abs(
                    xs.numpy() - np.asarray(jxs)).max()))


if __name__ == "__main__":
    # from the root of a checkout (~70 s on the CPU):
    #   JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_examples.py
    import json
    print(json.dumps(compare_multi_robot_mpc()))
