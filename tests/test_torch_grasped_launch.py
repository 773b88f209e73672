"""The launch side of the grasped-point branch of the CUDA terms, MultiRobot
terms and cost kernels (``ops/terms_kernel.py``), without a GPU: the
packed buffers of each kernel cut as its parse_layout cuts them (the
point-offset section, its count in the header, the grasped link's step
and offset records in the cost kernel's), the cost kernel's row count and
launch shape at the larger point count, and numpy models of the kernels
on those buffers held to the plain versions.

Tolerances: ``kin_scene.cuh::offset_point`` modelled in float32 numpy on
the packed offsets equals the plain version's grasped points bit for bit
(the same operations in the same order from the same link frames); the
float64 models of terms.cu and mr_terms.cu, and the float32 model of
cost.cu, against the plain terms and cost at the terms tolerance
(atol 3e-5 * max|ref| plus rtol 2e-5; float32 sums in another order)."""
import numpy as np
import pytest
import torch

from test_torch_cost_schedule import (_sections, model_cost,
                                     offset_point_model)
from test_torch_grasped import MR_BASES, MR_BOX, MR_YAWS
from test_torch_multi_robot import _rodrigues, model_mr_terms, mr_sections
from torch_robotics_tpu_torch.core import z_rot
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.geom import GraspedObjectPandaBox
from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout, fk_lanes
from torch_robotics_tpu_torch.ops.terms_kernel import (
    cost_launch_config, cost_row_ops, mr_terms_launch_config,
    pack_cost_kernel_params, pack_cost_params, pack_multirobot_params,
    pack_terms_params)
from torch_robotics_tpu_torch.robots import MultiRobot, RobotPanda, RobotUR10
from torch_robotics_tpu_torch.tasks import PlanningTask

F32 = np.float32
SMEM_MAX = 232448
ANC_ALL = 127          # the grasped link moves with all 7 joints


def _rand_q(lo, hi, n, seed):
    """q (d, n) over 1.4x the joint range: some joints past their clamps."""
    u = np.random.default_rng(seed).uniform(-0.2, 1.2, size=(lo.shape[0], n))
    return (lo[:, None] + u * (hi - lo)[:, None]).astype(F32)


@pytest.fixture(scope="module")
def panda():
    robot = RobotPanda.create(
        grasped_object=GraspedObjectPandaBox(device="cpu"), device="cpu")
    task = PlanningTask(env=EnvSpheres3D(device="cpu"), robot=robot,
                        obstacle_cutoff_margin=0.03)
    return task, TermsLayout(task)


@pytest.fixture(scope="module")
def multirobot():
    robot = MultiRobot.create(
        [RobotPanda.create(grasped_object=GraspedObjectPandaBox(
            size=MR_BOX, device="cpu"), device="cpu"),
         RobotPanda.create(device="cpu"), RobotUR10(device="cpu")],
        [(z_rot(torch.tensor(y, dtype=torch.float32)), torch.tensor(t))
         for y, t in zip(MR_YAWS, MR_BASES)])
    task = PlanningTask(env=EnvSpheres3D(device="cpu"), robot=robot,
                        obstacle_cutoff_margin=0.02)
    return task, task.collision_residuals.obstacle_terms_lanes.plain.layout


def terms_sections(ints, floats):
    """terms.cu's parse_layout in numpy: the cost kernel's sections
    (test_torch_cost_schedule's ``_sections``) and each point's joint mask
    closing the ints."""
    P = int(ints[2])
    a = _sections(ints[:-P], floats)
    a.update(anc=ints[-P:], G=int(ints[12]))
    return a


def test_terms_buffers_carry_the_offsets(panda):
    task, lay = panda
    ints, floats = pack_terms_params(lay)
    a = terms_sections(ints, floats)
    c_ints, c_floats = pack_cost_params(lay)
    np.testing.assert_array_equal(ints[:-a["P"]], c_ints)
    np.testing.assert_array_equal(floats, c_floats)
    assert (a["n_mem"], a["P"], a["NO"], a["K"], a["G"]) == (1, 23, 19, 66,
                                                              14)
    # the grasped link's step carries the 14 offset points, in order
    last = a["S"] - 1
    assert (a["pt_end"][last] - a["pt_begin"][last], a["n_off"][last]) == (
        14, 14)
    np.testing.assert_array_equal(
        a["pt_list"][a["pt_begin"][last]:a["pt_end"][last]],
        np.arange(9, 23))
    assert (a["anc"][-14:] == ANC_ALL).all()
    np.testing.assert_array_equal(a["offsets"][:, :3],
                                  task.robot.grasped_points.numpy())
    # object points: the 5 links' then the 14 grasped; pairs reach them
    np.testing.assert_array_equal(a["obj_pt"][5:], np.arange(9, 23))
    assert set(a["pair_a"][10:].tolist()) == set(range(9, 23))
    assert a["prims"].size == 4 * int(a["group_count"].sum())


def test_multirobot_buffers_carry_the_offsets(multirobot):
    """A grasped member's points are in its object section and in its self
    section, each an offset point of the grasped link's FK step with its
    own offset record (28), its joint mask all 7 joints; the mutual rows
    of the grasped points are listed on the cross blocks."""
    task, lay = multirobot
    ints, floats = pack_multirobot_params(lay)
    a = mr_sections(ints, floats)
    P, NO = a["P"], a["NO"]
    assert (P, NO, len(a["offsets"])) == (30 + 22 + 8 + 6, 30, 28)
    grasped = np.r_[5:19, 38:52]      # after the links of each section
    first_off = a["pt_end"] - a["n_off"]
    offset_pts = np.concatenate([a["pt_list"][f:e] for f, e in zip(
        first_off, a["pt_end"])])
    np.testing.assert_array_equal(np.sort(offset_pts), grasped)
    assert (a["anc"][grasped] == ANC_ALL).all()
    gp = task.robot.robots[0].grasped_points.numpy()
    np.testing.assert_array_equal(a["offsets"][:, :3],
                                  np.concatenate([gp, gp]))
    assert (a["offsets"][:, 3] == 0).all()
    # the mutual rows of the grasped points: 14 x (5 + 6) beside the
    # links' 5 x (5 + 6) and the second Panda's 5 x 6, each on one cross
    # block
    cross = a["entries"][a["bp_begin"][a["n_mem"]]:a["bp_begin"][-1]]
    assert len(cross) == 19 * 5 + 19 * 6 + 5 * 6
    launch = mr_terms_launch_config(ints, len(floats))
    assert launch["smem_bytes"] <= SMEM_MAX


def _cost_steps(ints, floats):
    """cost.cu's step records and offset records -> (steps (S, 8),
    offsets (NOFF, 4), pt_list)."""
    n_mem, P, S, NOFF = (int(ints[i]) for i in (0, 2, 7, 12))
    n_prims, NOBJ, NGRID = int(ints[10]), int(ints[5]), int(ints[11])
    steps = ints[16:16 + 8 * S].reshape(S, 8)
    o = 16 + 8 * S + n_mem + 1
    f = n_prims + 12 * NOBJ + 8 * NGRID + 20 * S
    assert f % 4 == 0                              # 16-byte records
    return steps, floats[f:f + 4 * NOFF].reshape(NOFF, 4), ints[o:o + P]


def test_cost_buffers_step_the_grasped_link(panda):
    task, lay = panda
    ints, floats = pack_cost_params(lay)
    steps, offs, pt_list = _cost_steps(ints, floats)
    assert int(ints[12]) == 14 and int(ints[2]) == 23
    # the chain's steps end at the grasped link, a fixed child of the
    # hand: it carries the 14 offset points, its records in order
    last = steps[-1]
    assert last[0] == 0 and last[2] == -2 and last[1] == -1
    assert (last[5] - last[4], last[6], last[7]) == (14, 14, 0)
    np.testing.assert_array_equal(pt_list[last[4]:last[5]], np.arange(9, 23))
    assert (steps[:-1, 6] == 0).all() and (steps[:-1, 7] == 0).all()
    np.testing.assert_array_equal(offs[:, :3],
                                  task.robot.grasped_points.numpy())
    assert (offs[:, 3] == 0).all()


def test_cost_rows_and_launch_shape(panda, multirobot):
    task, lay = panda
    ops = cost_row_ops(lay)
    assert len(ops) == 104
    # 15 per object + 10 per sphere of EnvSpheres3D's group, + 4 the hinge
    n_spheres = int(task.df_obj_list[0].fields[0].centers.shape[0])
    sdf = 15 + 10 * n_spheres + 4
    np.testing.assert_array_equal(ops, [sdf] * 19 + [16] * 85)
    ints, floats = pack_cost_params(lay)
    launch = cost_launch_config(ints, len(floats))
    assert (launch["threads_per_lane"], launch["lanes"]) == (1, 128)
    assert launch["smem_bytes"] == 4 * (
        -(-len(ints) // 4) * 4 + -(-len(floats) // 4) * 4
        + 128 * (7 + 3 * 23 + 1))
    _, mlay = multirobot
    m_ints, m_floats = pack_cost_params(mlay)
    assert int(m_ints[12]) == 28 and len(cost_row_ops(mlay)) == 2 * 30 + len(
        mlay.pair_a)
    m_launch = cost_launch_config(m_ints, len(m_floats))
    assert 3 <= m_launch["threads_per_lane"] <= 8
    assert m_launch["smem_bytes"] <= SMEM_MAX and m_launch["threads"] <= 256


def test_offset_point_model_is_the_plain_points_bit_for_bit(panda):
    """kin_scene.cuh's offset_point in float32 numpy, on the packed
    offsets and the plain FK's link frames, gives the plain version's
    grasped points bit for bit, and link-origin points are the origins."""
    task, lay = panda
    a = terms_sections(*pack_terms_params(lay))
    m = task.robot.model
    q = torch.as_tensor(_rand_q(m.q_lower, m.q_upper, 4096, seed=1))
    R_w, t_w = fk_lanes(m, q)
    plain = lay.points(R_w, t_w).numpy()                   # (23, 3, N)
    for s in range(a["S"]):
        first_off = a["pt_end"][s] - a["n_off"][s]
        for i in range(a["pt_begin"][s], a["pt_end"][s]):
            p = a["pt_list"][i]
            li = lay.point_links[p]
            if i < first_off:
                np.testing.assert_array_equal(plain[p], t_w[li].numpy())
                continue
            o = a["offsets"][a["off_begin"][s] + i - first_off, :3]
            x = offset_point_model(R_w[li].numpy(), t_w[li].numpy(), o)
            np.testing.assert_array_equal(x, plain[p])


def _sphere_sdf_grad(a, x):
    """Min-over-spheres SDF and gradient at x (3, N) on the packed scene
    (EnvSpheres3D: every group holds spheres, kind 0 or 3), float64."""
    best = np.full(x.shape[1], np.inf)
    grad = np.zeros_like(x)
    for o in range(a["NOBJ"]):
        R = a["obj_rot"][o].astype(np.float64).reshape(3, 3)
        xo = R.T @ (x - a["obj_pos"][o].astype(np.float64)[:, None])
        for g in range(a["obj_group_begin"][o], a["obj_group_begin"][o + 1]):
            assert a["group_kind"][g] in (0, 3)
            off = a["group_off"][g]
            for j in range(a["group_count"][g]):
                c = a["prims"][off + 4 * j: off + 4 * j + 4].astype(
                    np.float64)
                d = xo - c[:3, None]
                dist = np.sqrt((d * d).sum(0))
                s = dist - c[3]
                take = s < best
                best = np.where(take, s, best)
                grad = np.where(take, R @ (d / dist), grad)
    return best, grad


def model_terms(ints, floats, q):
    """g (D, N), Hqq (D, D, N), cost (N) computed as terms.cu computes
    them, in float64, from the packed buffers alone: the FK steps (parent
    from the root, the previous step or a slot) with each joint's world
    axis and origin, the points the steps place, then the rows, only the
    active ones adding their Jacobians."""
    a = terms_sections(ints, floats)
    q = q.astype(np.float64)
    N, D, P = q.shape[1], a["D"], a["P"]
    f64 = lambda v: np.asarray(v, np.float64)          # noqa: E731
    pts = np.zeros((P, 3, N))
    z, o = np.zeros((D, 3, N)), np.zeros((D, 3, N))
    slots = {}
    R = t = None
    for s in range(a["S"]):
        F = f64(a["frot"][s]).reshape(3, 3)
        tr = np.repeat(f64(a["trans"][s])[:, None], N, 1)
        qc, jt = a["qcol"][s], a["jtype"][s]
        if jt in (1, 2):
            qi = q[qc]
            if jt == 1:
                qi = np.clip(qi, a["clo"][s], a["chi"][s])
            Rl = np.einsum("ab,bcn->acn", F, _rodrigues(f64(a["axis"][s]),
                                                         qi))
        else:
            Rl = np.repeat(F[:, :, None], N, 2)
            if jt == 3:
                tr = tr + f64(a["axis"][s])[:, None] * np.clip(
                    q[qc], a["clo"][s], a["chi"][s])
        src = a["src"][s]
        if src == -1:
            R, t = Rl, tr
        else:
            Rp, tp = (R, t) if src == -2 else slots[src]
            R = np.einsum("abn,bcn->acn", Rp, Rl)
            t = np.einsum("abn,bn->an", Rp, tr) + tp
        if a["slot"][s] >= 0:
            slots[a["slot"][s]] = (R, t)
        if qc >= 0:
            in_lim = (q[qc] >= a["clo"][s]) & (q[qc] <= a["chi"][s])
            z[qc] = np.einsum("abn,b->an", R, f64(a["axis"][s])) * in_lim
            o[qc] = t
        first_off = a["pt_end"][s] - a["n_off"][s]
        for i in range(a["pt_begin"][s], a["pt_end"][s]):
            p = a["pt_list"][i]
            pts[p] = t if i < first_off else np.einsum(
                "abn,b->an", R,
                f64(a["offsets"][a["off_begin"][s] + i - first_off, :3])) + t

    def jac(p, j):
        if not (a["anc"][p] >> j) & 1:
            return np.zeros((3, N))
        return np.cross(z[j], pts[p] - o[j], axis=0)

    g, H, cost = np.zeros((D, N)), np.zeros((D, D, N)), np.zeros(N)

    def add(r, Jr):
        """r (N,), Jr (D, N): an active lane's row; the others add 0."""
        nonlocal cost
        live = r > 0
        r, Jr = np.where(live, r, 0.0), np.where(live, Jr, 0.0)
        cost = cost + r * r
        g[:] += r * Jr
        H[:] += Jr[:, None] * Jr[None]

    rows = []
    for mi in range(a["NO"]):
        p = a["obj_pt"][mi]
        rows.append((p, *_sphere_sdf_grad(a, pts[p]), mi))
    ws_min, ws_max = f64(a["ws_min"]), f64(a["ws_max"])
    for mi in range(a["NO"]):
        p = a["obj_pt"][mi]
        x = pts[p]
        faces = np.concatenate([x - ws_min[:, None], ws_max[:, None] - x])
        fi = np.argmin(faces, 0)
        wgrad = np.stack([np.where(fi == k, 1.0, 0.0)
                          - np.where(fi == k + 3, 1.0, 0.0) for k in range(3)])
        rows.append((p, faces.min(0), wgrad, mi))
    for p, val, grad, mi in rows:
        r = np.maximum(a["obj_thresh"][mi] - val, 0.0)
        add(r, np.stack([-(grad * jac(p, j)).sum(0) for j in range(D)]))
    for k in range(a["K"]):
        pa, pb = a["pair_a"][k], a["pair_b"][k]
        diff = pts[pa] - pts[pb]
        dist = np.sqrt((diff * diff).sum(0))
        r = np.maximum(a["pair_margin"][k] - dist, 0.0)
        u = diff / dist
        add(r, np.stack([-(u * (jac(pa, j) - jac(pb, j))).sum(0)
                         for j in range(D)]))
    return g, H, 0.5 * cost


def _hold(got, ref, name):
    for a, r in zip(got, ref):
        r = r.double().numpy()
        assert float(np.abs(r).max()) > 0, name
        np.testing.assert_allclose(a, r, atol=3e-5 * np.abs(r).max(),
                                   rtol=2e-5, err_msg=name)


def test_kernel_models_on_the_buffers_match_plain(panda):
    """The float64 model of terms.cu and the float32 model of cost.cu, run
    on the grasped Panda's packed buffers, give the plain terms and
    cost."""
    task, lay = panda
    m = task.robot.model
    q = _rand_q(m.q_lower, m.q_upper, 256, seed=2)
    plain = task.collision_residuals.obstacle_terms_lanes.plain
    ref = plain.unscaled(torch.as_tensor(q))
    _hold(model_terms(*pack_terms_params(lay), q), ref, "terms")
    got = model_cost(*pack_cost_kernel_params(lay), q)
    _hold([got], [ref[2]], "cost")


def test_multirobot_models_on_the_buffers_match_plain(multirobot):
    task, lay = multirobot
    lo, hi = task.robot.q_min.numpy(), task.robot.q_max.numpy()
    q = _rand_q(lo, hi, 128, seed=3)
    ref = task.collision_residuals.obstacle_terms_lanes.plain.unscaled(
        torch.as_tensor(q))
    _hold(model_mr_terms(*pack_multirobot_params(lay), q), ref, "mr terms")
    _hold([model_cost(*pack_cost_kernel_params(lay), q)], [ref[2]],
          "mr cost")
