"""A numpy model of the CUDA value-only cost kernel (``csrc/cost.cu``), run
on the packed parameters (``pack_cost_kernel_params``) in the kernel's own
order: each member's FK steps with their parent sources (base, previous
step, stored slot) and their classes (a coordinate-axis joint's rotation
and F Rj with the exact zeros taken out, an identity parent, a fixed
joint with F = I, a step whose R nothing reads), the collision points the
steps write, then each thread's range of rows in row order (object rows
four points at a time and the last one to three together, pair rows
from their records, the root skipped past the guard) and a lane's
partial sums added in thread order.

It is held to the port's plain cost (the cost output of the unscaled
plain terms) and, for the iLQR path's Panda, to the JAX package's
``collision_cost_pallas_factory`` in interpret mode, on the same seeded
numpy q (N = 256).  The MultiRobot embodiments, the grasped Panda, the
grid scene and grasped config 4 are held to the plain version only:
tests/test_torch_mr_cost.py holds that to the JAX kernel at the same
tolerance (its MultiRobot branch takes 6-10 s to compile in interpret
mode).  Tolerances as tests/test_torch_cost.py (atol 3e-5 * max|ref|,
rtol 2e-5) and tests/test_torch_mr_cost.py (atol 2e-5 * max|ref|, rtol
2e-5): float32 sums in another order.  No robot of the zoo branches, so
a Panda whose links 7 and 9 hang from links 3 and 5 runs the
stored-transform path, held to the plain version.  EnvSpheres3D's
spheres share one radius (the kernel's one-root group); a copy with
radii spread over 0.6-1.4x runs the per-sphere group.  Panda copies with
every joint about -y or +x run the other axis classes."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cost import SCENES
from test_torch_grasped import port_grasped_multirobot
from test_torch_kin import export_jax_task
from test_torch_mr_cost import EMBODIMENTS
from test_torch_multi_robot import (export_jax_multirobot_task, jax_task,
                                    rand_q)
from test_torch_terms import _rand_q
from torch_robotics_tpu.ops.pallas_terms import \
    collision_cost_pallas_factory as jax_cost_factory
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.convert import task_from_numpy
from torch_robotics_tpu_torch.envs import EnvMazeBoxes3D, EnvSpheres3D
from torch_robotics_tpu_torch.geom import GraspedObjectPandaBox
from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
from torch_robotics_tpu_torch.ops.terms_kernel import (
    pack_cost_kernel_params, scene_grid_table)
from torch_robotics_tpu_torch.robots import RobotPanda
from torch_robotics_tpu_torch.tasks import PlanningTask

N = 256
F32 = np.float32


def _sections(ints, floats):
    """The packed buffers cut as cost.cu's parse_layout cuts them, the
    step records split into their fields, and K8's own sections (step
    classes, pair records) where ints[14] locates them."""
    (n_mem, D, P, NO, K, NOBJ, NG, S, n_slots, T, n_prims, NGRID, NOFF) = (
        int(v) for v in ints[:13])
    a, o = {}, 16
    step_i = ints[o:o + 8 * S].reshape(S, 8)
    o += 8 * S
    for name, n in (("mem_step", n_mem + 1), ("pt_list", P), ("obj_pt", NO),
                    ("pair_a", K), ("pair_b", K), ("cuts", T + 1),
                    ("obj_group_begin", NOBJ + 1), ("group_kind", NG),
                    ("group_count", NG), ("group_off", NG),
                    ("obj_grid", NOBJ), ("grid_i", 4 * NGRID)):
        a[name], o = ints[o:o + n], o + n
    a["prims"], o = floats[:n_prims], n_prims
    objects = floats[o:o + 12 * NOBJ].reshape(NOBJ, 12)
    o += 12 * NOBJ
    a["grid_f"] = floats[o:o + 8 * NGRID].reshape(NGRID, 8)
    o += 8 * NGRID
    step_f = floats[o:o + 20 * S].reshape(S, 20)
    o += 20 * S
    a["offsets"] = floats[o:o + 4 * NOFF].reshape(NOFF, 4)
    o += 4 * NOFF
    for name, n in (("base_R", 9 * n_mem), ("base_t", 3 * n_mem),
                    ("obj_thresh", NO), ("pair_margin", K), ("ws_min", 3),
                    ("ws_max", 3)):
        a[name], o = floats[o:o + n], o + n
    assert o == len(floats)
    if ints[14]:                   # K8's own sections (cost.cu)
        k, p = int(ints[14]), int(ints[15])
        assert p % 4 == 0 and k + S <= p and p + 4 * K == len(ints)
        a["step_cls"] = ints[k:k + S]
        a["pair_rec"] = ints[p:p + 4 * K].reshape(K, 4)
    a.update(jtype=step_i[:, 0], qcol=step_i[:, 1], src=step_i[:, 2],
             slot=step_i[:, 3], pt_begin=step_i[:, 4], pt_end=step_i[:, 5],
             n_off=step_i[:, 6], off_begin=step_i[:, 7],
             frot=step_f[:, :9], trans=step_f[:, 9:12], axis=step_f[:, 12:15],
             clo=step_f[:, 15], chi=step_f[:, 16], obj_rot=objects[:, :9],
             obj_pos=objects[:, 9:], n_mem=n_mem, D=D, P=P, NO=NO, K=K,
             NOBJ=NOBJ, S=S, n_slots=n_slots, T=T)
    return a


def _joint(jt, F, axis, lo, hi, q):
    """(Rl (3, 3, N), tr (3, N)) as cost.cuh's joint_transform."""
    Rl = np.broadcast_to(F[:, :, None], (3, 3, q.shape[0])).astype(F32)
    tr = np.zeros((3, q.shape[0]), F32)
    if jt in (1, 2):
        qi = np.clip(q, lo, hi) if jt == 1 else q
        s, c = np.sin(qi), np.cos(qi)
        oc = F32(1) - c
        ax, ay, az = axis
        Rj = np.stack([
            1 + oc * (ax * ax - 1), -s * az + oc * (ax * ay),
            s * ay + oc * (ax * az), s * az + oc * (ax * ay),
            1 + oc * (ay * ay - 1), -s * ax + oc * (ay * az),
            -s * ay + oc * (ax * az), s * ax + oc * (ay * az),
            1 + oc * (az * az - 1)]).reshape(3, 3, -1).astype(F32)
        Rl = np.einsum("ij,jkn->ikn", F, Rj).astype(F32)
    elif jt == 3:
        tr = (axis[:, None] * np.clip(q, lo, hi)[None]).astype(F32)
    return Rl, tr


def _fma(a, b, c):
    """a b + c rounded once to float32 (the product is exact in float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def _axis_joint(cls, jt, F, lo, hi, q):
    """cost.cu's axis_joint: Rl (3, 3, N) of a joint about a signed
    coordinate axis, only F Rj's nonzero terms, the one the general
    product's contraction rounds alone first."""
    qi = np.clip(q, lo, hi) if jt == 1 else q
    s, c = np.sin(qi).astype(F32), np.cos(qi).astype(F32)
    oc = F32(1) - c
    C, S = F32(1) - oc, (-s if cls & 4 else s)
    Rl = np.empty((3, 3, q.shape[0]), F32)
    for i in range(3):
        f0, f1, f2 = F[i]
        if cls & 3 == 3:                                 # z
            Rl[i, 0] = _fma(f0, C, f1 * S)
            Rl[i, 1] = _fma(f0, -S, f1 * C)
            Rl[i, 2] = f2
        elif cls & 3 == 2:                               # y
            Rl[i, 0] = _fma(f2, -S, f0 * C)
            Rl[i, 1] = f1
            Rl[i, 2] = _fma(f2, C, f0 * S)
        else:                                            # x
            Rl[i, 0] = f0
            Rl[i, 1] = _fma(f2, S, f1 * C)
            Rl[i, 2] = _fma(f2, C, f1 * -S)
    return Rl


def _grid_value(a, gidx, grid, x):
    """kin_scene.cuh's grid_sdf<false> at points x (3, N): the nearest
    cell's SDF from the scene's (C, 4) table."""
    gi, gf = a["grid_i"][4 * gidx:4 * gidx + 4], a["grid_f"][gidx]
    flat = np.zeros(x.shape[1], np.int64)
    for k in range(3):
        c = F32(gi[1 + k])
        v = np.floor(((x[k] - gf[k]).astype(F32) / gf[4 + k]).astype(F32)
                     * c)
        flat = flat * int(gi[1 + k]) + np.clip(v, 0, c - 1).astype(np.int64)
    return grid[int(gi[0]) + flat, 0]


def _scene_sdf(a, x, grid=None):
    """Min over the scene's primitives and grids at world points x (3,
    N)."""
    best = np.full(x.shape[1], np.inf, F32)
    for o in range(a["NOBJ"]):
        if a["obj_grid"][o] >= 0:
            best = np.minimum(best, _grid_value(a, a["obj_grid"][o], grid, x))
            continue
        R = a["obj_rot"][o].reshape(3, 3)
        xo = (R.T @ (x - a["obj_pos"][o][:, None])).astype(F32)
        for g in range(a["obj_group_begin"][o], a["obj_group_begin"][o + 1]):
            kind, cnt = a["group_kind"][g], a["group_count"][g]
            width = (4, 7, 6, 4)[kind]
            off = a["group_off"][g]
            assert off % 4 == 0                  # 16-byte aligned tables
            pr = a["prims"][off:off + width * cnt].reshape(cnt, width)
            d = xo[None] - pr[:, :3, None]                   # (cnt, 3, N)
            if kind in (0, 3):                   # 3: one radius
                assert kind == 0 or len(set(pr[:, 3])) == 1
                s = np.sqrt((d * d).sum(1)) - pr[:, 3, None]
            elif kind == 1:
                rr = pr[:, 6, None, None]
                qq = np.abs(d) - pr[:, 3:6, None] + rr
                s = (np.minimum(qq.max(1), 0)
                     + np.sqrt((np.maximum(qq, 0) ** 2).sum(1)) - rr[:, 0])
            else:
                s = (np.abs(d) - pr[:, 3:6, None]).max(1)
            best = np.minimum(best, s.min(0).astype(F32))
    return best


def offset_point_model(R, t, o):
    """kin_scene.cuh's offset_point in float32 numpy: R (3, 3, N), t (3,
    N), o (3,) -> ((R0 o0 + R1 o1) + R2 o2) + t (3, N), each product and
    sum rounded to float32."""
    o = o.astype(F32)
    return (((R[:, 0] * o[0]).astype(F32) + (R[:, 1] * o[1]).astype(F32))
            .astype(F32) + (R[:, 2] * o[2]).astype(F32)).astype(F32) + t


def model_cost(ints, floats, q, grid=None):
    """The kernel's arithmetic in its order, float32 numpy: q (d, N) ->
    cost (N,), on ``pack_cost_kernel_params``' buffers (``grid`` the
    scene's (C, 4) grid table as numpy, for a grid scene)."""
    a = _sections(ints, floats)
    n = q.shape[1]
    pts = np.zeros((a["P"], 3, n), F32)
    slots = np.zeros((a["n_slots"], 12, n), F32)
    for m in range(a["n_mem"]):                       # phase 1
        R = t = None
        for s in range(a["mem_step"][m], a["mem_step"][m + 1]):
            cls = int(a["step_cls"][s])
            qc = a["qcol"][s]
            qs = q[qc] if qc >= 0 else np.zeros(n, F32)
            F = a["frot"][s].reshape(3, 3)
            Rl, tr = _joint(a["jtype"][s], F, a["axis"][s], a["clo"][s],
                            a["chi"][s], qs)
            if cls & 3:
                Rl = _axis_joint(cls, a["jtype"][s], F, a["clo"][s],
                                 a["chi"][s], qs)
            tr = tr + a["trans"][s][:, None]
            src = a["src"][s]
            if src == -2:
                Rp, tp = R, t
            elif src == -1:
                Rp = np.broadcast_to(a["base_R"][9 * m:9 * m + 9]
                                     .reshape(3, 3, 1), (3, 3, n))
                tp = np.broadcast_to(a["base_t"][3 * m:3 * m + 3, None],
                                     (3, n))
            else:
                Rp = slots[src, :9].reshape(3, 3, n)
                tp = slots[src, 9:]
            if cls & 16:                              # identity parent
                np.testing.assert_array_equal(np.abs(Rp[..., 0]), np.eye(3))
                R, t = Rl, (tr + tp).astype(F32)
            else:
                t = (np.einsum("ijn,jn->in", Rp, tr) + tp).astype(F32)
                if cls & 32:                          # F = I: R stays
                    np.testing.assert_array_equal(F, np.eye(3))
                    R = Rp
                elif cls & 8:
                    R = np.einsum("ijn,jkn->ikn", Rp, Rl).astype(F32)
                else:                                 # R read by nothing
                    R = None
            if a["slot"][s] >= 0:
                slots[a["slot"][s]] = np.concatenate([R.reshape(9, n), t])
            first_off = a["pt_end"][s] - a["n_off"][s]
            for i in range(a["pt_begin"][s], a["pt_end"][s]):
                p = a["pt_list"][i]
                if i < first_off:                     # the link's origin
                    pts[p] = t
                    continue
                o = a["offsets"][a["off_begin"][s] + i - first_off]
                assert o[3] == 0
                pts[p] = offset_point_model(R, t, o[:3])
    n_sdf = a["NO"] if a["NOBJ"] > 0 else 0
    parts = []
    for th in range(a["T"]):                          # phase 2
        acc = np.zeros(n, F32)
        r, end = a["cuts"][th], a["cuts"][th + 1]
        sdf_end = min(end, n_sdf)
        while r < sdf_end:          # 4 points a pass, then the last 1-3
            nb = min(4, sdf_end - r)
            for k in range(nb):
                val = _scene_sdf(a, pts[a["obj_pt"][r + k]], grid)
                h = np.maximum(a["obj_thresh"][r + k] - val, 0)
                acc = (acc + h * h).astype(F32)
            r += nb
        for r in range(r, end):
            if r < n_sdf + a["NO"]:
                mi = r - n_sdf
                x = pts[a["obj_pt"][mi]]
                val = np.minimum((x - a["ws_min"][:, None]).min(0),
                                 (a["ws_max"][:, None] - x).min(0))
                h = np.maximum(a["obj_thresh"][mi] - val, 0)
            else:
                pa, pb, m_bits, g_bits = a["pair_rec"][r - n_sdf - a["NO"]]
                margin = np.int32(m_bits).view(F32)
                guard = np.int32(g_bits).view(F32)
                diff = pts[pa] - pts[pb]
                d2 = (diff * diff).sum(0)
                h = np.where(d2 > guard, F32(0),
                             np.maximum(margin - np.sqrt(d2), 0))
            acc = (acc + h * h).astype(F32)
        parts.append(acc)
    c = np.zeros(n, F32)
    for p in parts:
        c = (c + p).astype(F32)
    return F32(0.5) * c


def _single_tasks(name):
    """(JAX task, port task) of tests/test_torch_cost.py's scene; the maze
    is built in the port alone (the JAX maze takes seconds to build)."""
    make_env, self_margin, cutoff = SCENES[name]
    if name == "maze_boxes3d":
        return None, PlanningTask(
            env=EnvMazeBoxes3D(device="cpu"),
            robot=RobotPanda.create(self_collision_margin_robot=self_margin,
                                    device="cpu"),
            obstacle_cutoff_margin=cutoff)
    jtask = JPlanningTask(
        env=make_env(),
        robot=JRobotPanda.create(self_collision_margin_robot=self_margin),
        obstacle_cutoff_margin=cutoff)
    return jtask, task_from_numpy(export_jax_task(jtask), device="cpu")


def _hold(got, ref, atol_rel, name):
    assert got.shape == ref.shape and np.isfinite(got).all(), name
    assert float(np.abs(ref).max()) > 0, name
    np.testing.assert_allclose(got, ref, atol=atol_rel * np.abs(ref).max(),
                               rtol=2e-5, err_msg=name)


def varied_radii_task():
    """EnvSpheres3D with its spheres' radii spread over 0.6-1.4x, so the
    scene's group keeps a radius per sphere (kind 0)."""
    env = EnvSpheres3D(device="cpu")
    sph = env.obj_fixed_list[0].fields[0]
    sph.radii.mul_(torch.linspace(0.6, 1.4, sph.radii.shape[0]))
    return PlanningTask(env=env, robot=RobotPanda.create(device="cpu"),
                        obstacle_cutoff_margin=0.06)


@pytest.mark.parametrize("name", sorted(SCENES) + ["varied_radii"])
def test_single_robot_model_matches_plain(name):
    if name == "varied_radii":
        jtask, ptask = None, varied_radii_task()
    else:
        jtask, ptask = _single_tasks(name)
    q = _rand_q(ptask, N, seed=21)
    ints, floats = pack_cost_kernel_params(TermsLayout(ptask))
    kinds = set(_sections(ints, floats)["group_kind"].tolist())
    if "spheres" in name:                  # EnvSpheres3D: one radius
        assert kinds == {3}
    elif name == "varied_radii":
        assert kinds == {0}
    plain = ptask.collision_residuals.collision_cost_lanes.plain(
        torch.as_tensor(q)).numpy()
    got = model_cost(ints, floats, q)
    _hold(got, plain, 3e-5, name)
    if name == "spheres3d_cutoff006":           # the iLQR / sGPMP Panda
        ref = np.asarray(jax_cost_factory(jtask)(jnp.asarray(q),
                                                 interpret=True))
        _hold(got, ref, 3e-5, name + " vs JAX")


@pytest.mark.parametrize("name", sorted(EMBODIMENTS))
def test_multirobot_model_matches_plain(name):
    jtask = jax_task(EMBODIMENTS[name])
    ptask = task_from_numpy(export_jax_multirobot_task(jtask), device="cpu")
    q = rand_q(ptask.robot, N, seed=22)
    cost = ptask.collision_residuals.collision_cost_lanes
    plain = cost.plain(torch.as_tensor(q)).numpy()
    ints, floats = pack_cost_kernel_params(
        ptask.collision_residuals.obstacle_terms_lanes.plain.layout)
    assert ints[9] > 1                     # rows spread over threads
    _hold(model_cost(ints, floats, q), plain, 2e-5, name)


def branching_panda_task():
    """The Panda with link 7 hung from link 3 and link 9 from link 5: links
    3 and 5 then have two children, so their transforms are stored."""
    robot = RobotPanda.create(device="cpu")
    parent = list(robot.model.parent_idx)
    parent[7], parent[9] = 3, 5
    model = dataclasses.replace(robot.model, parent_idx=tuple(parent))
    return PlanningTask(env=EnvSpheres3D(device="cpu"),
                        robot=dataclasses.replace(robot, model=model),
                        obstacle_cutoff_margin=0.06)


def test_branching_tree_takes_the_stored_transforms():
    task = branching_panda_task()
    ints, floats = pack_cost_kernel_params(TermsLayout(task))
    a = _sections(ints, floats)
    assert a["n_slots"] == 2
    assert sorted(v for v in a["src"] if v >= 0) == [0, 1]
    q = _rand_q(task, N, seed=23)
    plain = task.collision_residuals.collision_cost_lanes.plain(
        torch.as_tensor(q)).numpy()
    _hold(model_cost(ints, floats, q), plain, 3e-5, "branching")


def axis_panda_task(k, sign):
    """The Panda with every revolute joint about ``sign`` e_k (its fixed
    rotations as they are): the other axis classes of cost.cu's FK."""
    robot = RobotPanda.create(device="cpu")
    axis = np.array(robot.model.joint_axis)
    for i, jt in enumerate(robot.model.joint_types):
        if jt in (1, 2):
            axis[i] = 0
            axis[i, k] = sign
    model = dataclasses.replace(robot.model, joint_axis=axis.astype(F32))
    return PlanningTask(env=EnvSpheres3D(device="cpu"),
                        robot=dataclasses.replace(robot, model=model),
                        obstacle_cutoff_margin=0.06)


def more_tasks(name):
    """(task, grid table or None, tolerance) of the branches the redesign
    is for and of the axis classes no zoo robot has: the grasped Panda at
    the iLQR cutoff, the Panda in EnvSpheres3D's grid (0.05 m cells),
    grasped config 4 and Pandas with every joint about +x or -y."""
    if name == "grasped":
        robot = RobotPanda.create(
            grasped_object=GraspedObjectPandaBox(device="cpu"), device="cpu")
        return PlanningTask(env=EnvSpheres3D(device="cpu"), robot=robot,
                            obstacle_cutoff_margin=0.06), None, 3e-5
    if name == "grid":
        env = EnvSpheres3D(precompute_sdf_obj_fixed=True, sdf_cell_size=0.05,
                           device="cpu")
        task = PlanningTask(env=env, robot=RobotPanda.create(device="cpu"),
                            obstacle_cutoff_margin=0.06)
        return task, scene_grid_table(task.df_obj_list).numpy(), 3e-5
    if name == "grasped_config4":
        return port_grasped_multirobot(), None, 2e-5
    return axis_panda_task(*{"axis_x": (0, 1.0),
                             "axis_y_neg": (1, -1.0)}[name]), None, 3e-5


@pytest.mark.parametrize("name", ["grasped", "grid", "grasped_config4",
                                  "axis_x", "axis_y_neg"])
def test_redesigned_branches_model_matches_plain(name):
    task, grid, atol_rel = more_tasks(name)
    res = task.collision_residuals
    lay = res.obstacle_terms_lanes.plain.layout
    ints, floats = pack_cost_kernel_params(lay)
    if hasattr(task.robot, "model"):
        q = _rand_q(task, N, seed=24)
    else:
        q = rand_q(task.robot, N, seed=24)
    plain = res.collision_cost_lanes.plain(torch.as_tensor(q)).numpy()
    got = model_cost(ints, floats, q, grid)
    _hold(got, plain, atol_rel, name)
    if name.startswith("axis"):
        classes = _sections(ints, floats)["step_cls"]
        assert {int(c) & 7 for c in classes} >= {
            {"axis_x": 1, "axis_y_neg": 2 | 4}[name]}
