"""What lets the CUDA terms kernel (``csrc/terms.cu``) build a row's
Jacobian and add its Hessian only where the row is active, without a GPU:
on the plain version, an inactive row (r = 0) adds nothing, so the terms
with every inactive row's Jacobian zeroed before the sums are the plain
terms bit for bit (values; signed zeros compare equal), for the
pair-field, grasped, grid and net Panda on uniform and straight-line q;
the numpy model of the kernel on its packed buffers
(tests/test_torch_grasped_launch.py's ``model_terms``, which adds only
active rows) held to the plain terms for the pair-field and net Panda
(the net row excluded: it runs in csrc/net_row.cu after the kernel); and
the kernel's launch shape (``terms_launch_config``).

Tolerance of the model: the terms tolerance (atol 3e-5 * max|ref| plus
rtol 2e-5; float64 against float32 sums in another order)."""
import numpy as np
import pytest
import torch

from test_torch_grasped_launch import model_terms
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.geom import GraspedObjectPandaBox
from torch_robotics_tpu_torch.ops.terms_kernel import (pack_terms_params,
                                                       terms_launch_config)
from torch_robotics_tpu_torch.robots import RobotPanda
from torch_robotics_tpu_torch.solve import straight_line_trajs
from torch_robotics_tpu_torch.tasks import PlanningTask

SMEM_MAX = 232448
N_WAY, N_PROB = 16, 32          # straight-line q: 16 waypoints of 32 plans


def _task(kind):
    env = (EnvSpheres3D(precompute_sdf_obj_fixed=True, sdf_cell_size=0.05,
                        device="cpu") if kind == "grid"
           else EnvSpheres3D(device="cpu"))
    robot = RobotPanda.create(
        grasped_object=(GraspedObjectPandaBox(device="cpu")
                        if kind == "grasped" else None),
        use_learned_self_collision=kind == "net", device="cpu")
    return PlanningTask(env=env, robot=robot, obstacle_cutoff_margin=0.03)


@pytest.fixture(scope="module")
def tasks():
    return {k: _task(k) for k in ("pair_field", "grasped", "grid", "net")}


def _q(task, which, seed=0):
    """q (7, N): uniform over the joint limits (N = 512), or the
    straight-line plans of bench.py's start / goal draw, h-major lanes
    (N = 16 x 32)."""
    rng = np.random.default_rng(seed)
    lo, hi = task.robot.model.q_lower, task.robot.model.q_upper
    if which == "uniform":
        q = lo[:, None] + rng.uniform(size=(7, 512)) * (hi - lo)[:, None]
        return torch.as_tensor(q, dtype=torch.float32)
    u1, u2 = rng.uniform(size=(2, N_PROB, 7))
    start = lo + 0.25 * (hi - lo) * (1 + u1) / 2
    goal = hi - 0.25 * (hi - lo) * (1 + u2) / 2
    z = np.zeros_like(start)
    s, g = (torch.as_tensor(np.concatenate([v, z], -1), dtype=torch.float32)
            for v in (start, goal))
    return (straight_line_trajs(s, g, N_WAY)[..., :7]
            .permute(2, 1, 0).reshape(7, -1).contiguous())


@pytest.mark.parametrize("which", ["uniform", "straight_line"])
@pytest.mark.parametrize("kind", ["pair_field", "grasped", "grid", "net"])
def test_inactive_rows_add_nothing(tasks, kind, which):
    plain = tasks[kind].collision_residuals.obstacle_terms_lanes.plain
    q = _q(tasks[kind], which)
    r, Jr = plain.rows(q)
    active = r > 0
    assert bool(active.any()) and not bool(active.all())
    Jz = torch.where(active[:, None], Jr, torch.zeros((), dtype=Jr.dtype))
    g, Hqq, cost = plain.unscaled(q)
    assert torch.equal(g, torch.sum(r[:, None] * Jz, dim=0))
    assert torch.equal(Hqq, torch.sum(Jz[:, :, None] * Jz[:, None, :], dim=0))
    assert torch.equal(cost, 0.5 * torch.sum(r * r, dim=0))


@pytest.mark.parametrize("kind", ["pair_field", "net"])
def test_active_row_model_matches_plain(tasks, kind):
    """The kernel's model on its buffers against the plain rows without
    the net row (the last row of the net Panda's)."""
    task = tasks[kind]
    plain = task.collision_residuals.obstacle_terms_lanes.plain
    q = _q(task, "uniform", seed=3)
    r, Jr = plain.rows(q)
    if kind == "net":
        r, Jr = r[:-1], Jr[:-1]
    ref = (torch.sum(r[:, None] * Jr, dim=0),
           torch.sum(Jr[:, :, None] * Jr[:, None, :], dim=0),
           0.5 * torch.sum(r * r, dim=0))
    got = model_terms(*pack_terms_params(plain.layout), q.numpy())
    for a, b in zip(got, ref):
        b = b.double().numpy()
        assert float(np.abs(b).max()) > 0
        np.testing.assert_allclose(a, b, atol=3e-5 * np.abs(b).max(),
                                   rtol=2e-5)


def test_terms_launch_config(tasks):
    """128 lanes a block; the shared bytes are the parameters (each buffer
    rounded up to 16 bytes) and per lane q, the joint axes and origins,
    the points and the stored transforms; fewer whole warps where 128 lanes
    pass the H100's bytes; a block that does not fit at 32 lanes raises."""
    for kind, task in tasks.items():
        lay = task.collision_residuals.obstacle_terms_lanes.plain.layout
        ints, floats = pack_terms_params(lay)
        D, P, n_slots = int(ints[1]), int(ints[2]), int(ints[8])
        cfg = terms_launch_config(ints, len(floats))
        fixed = 4 * (-(-len(ints) // 4) * 4 + -(-len(floats) // 4) * 4)
        per_lane = 4 * (7 * D + 3 * P + 12 * n_slots)
        assert cfg == dict(lanes=128, smem_bytes=fixed + 128 * per_lane)
        assert cfg["smem_bytes"] <= SMEM_MAX
        assert terms_launch_config(ints, len(floats), lanes=32)[
            "smem_bytes"] == fixed + 32 * per_lane
    big = ints.copy()
    big[2] = 500                                   # 500 points a lane
    cfg = terms_launch_config(big, len(floats))
    assert cfg["lanes"] % 32 == 0 and cfg["lanes"] < 128
    assert cfg["smem_bytes"] <= SMEM_MAX
    assert cfg["smem_bytes"] + 32 * 4 * (7 * D + 3 * 500 + 12 * n_slots) \
        > SMEM_MAX
    big[2] = 5000
    with pytest.raises(NotImplementedError, match="shared memory"):
        terms_launch_config(big, len(floats))
