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

from test_torch_cost_schedule import model_cost, offset_point_model
from test_torch_grasped import MR_BASES, MR_BOX, MR_YAWS
from test_torch_multi_robot import _rodrigues, _scene_sdf_grad, model_mr_terms
from torch_robotics_tpu_torch.core import z_rot
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.geom import GraspedObjectPandaBox
from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout, fk_lanes
from torch_robotics_tpu_torch.ops.terms_kernel import (
    cost_launch_config, cost_row_ops, mr_shared_bytes, pack_cost_params,
    pack_multirobot_params, pack_terms_params)
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
    """terms.cu's parse_layout in numpy."""
    L, D, P, NO, K, NOBJ, NG, NGRID, G = (int(v) for v in ints[:9])
    a, o = dict(L=L, D=D, P=P, NO=NO, K=K, NOBJ=NOBJ, NG=NG, G=G), 9
    for name, n in (("topo", L), ("parent", L), ("jtype", L), ("qidx", L),
                    ("ctrl", D), ("point_link", P), ("anc", P),
                    ("obj_pt", NO), ("pair_a", K), ("pair_b", K),
                    ("obj_group_begin", NOBJ + 1), ("group_kind", NG),
                    ("group_count", NG), ("group_off", NG),
                    ("obj_grid", NOBJ), ("grid_i", 4 * NGRID)):
        a[name], o = ints[o:o + n], o + n
    assert o == len(ints)
    f = 0
    for name, n in (("trans", 3 * L), ("frot", 9 * L), ("axis", 3 * L),
                    ("clo", L), ("chi", L), ("obj_thresh", NO),
                    ("pair_margin", K), ("ws_min", 3), ("ws_max", 3),
                    ("pt_off", 3 * G), ("obj_rot", 9 * NOBJ),
                    ("obj_pos", 3 * NOBJ), ("grid_f", 8 * NGRID)):
        a[name], f = floats[f:f + n], f + n
    a["prims"] = floats[f:]
    return a


def test_terms_buffers_carry_the_offsets(panda):
    task, lay = panda
    ints, floats = pack_terms_params(lay)
    a = terms_sections(ints, floats)
    assert (a["L"], a["P"], a["NO"], a["K"], a["G"]) == (12, 23, 19, 66, 14)
    np.testing.assert_array_equal(a["point_link"][-14:], [11] * 14)
    np.testing.assert_array_equal(a["point_link"][:9], lay.used_links)
    assert (a["anc"][-14:] == ANC_ALL).all()
    np.testing.assert_array_equal(
        a["pt_off"], task.robot.grasped_points.numpy().reshape(-1))
    # object points: the 5 links' then the 14 grasped; pairs reach them
    np.testing.assert_array_equal(a["obj_pt"][5:], np.arange(9, 23))
    assert set(a["pair_a"][10:].tolist()) == set(range(9, 23))
    assert a["prims"].size == 4 * int(a["group_count"].sum())


def test_multirobot_buffers_carry_the_offsets(multirobot):
    """A grasped member's points are in its object section and in its self
    section: each with its own offset record (28), the others -1."""
    task, lay = multirobot
    ints, floats = pack_multirobot_params(lay)
    P, D, NO, NGP = int(ints[2]), int(ints[1]), int(ints[3]), int(ints[11])
    assert (P, NO, NGP) == (30 + 22 + 8 + 6, 30, 28)
    n_mem, n_bp, L_sum = int(ints[0]), int(ints[8]), int(ints[9])
    o = 16 + 8 * n_mem + 4 * n_bp + 4 * L_sum + D
    pt_link, pt_anc = ints[o + P:o + 2 * P], ints[o + 2 * P:o + 3 * P]
    pt_goff = ints[o + 3 * P:o + 4 * P]
    grasped = np.r_[5:19, 38:52]      # after the links of each section
    np.testing.assert_array_equal(pt_goff[grasped], np.arange(28))
    assert (np.delete(pt_goff, grasped) == -1).all()
    assert (pt_link[grasped] == 11).all()
    assert (pt_anc[grasped] == ANC_ALL).all()
    K_own, K_mut = int(ints[4]), int(ints[5])
    f = 17 * L_sum + 12 * n_mem + NO + K_own + K_mut + 6
    gp = task.robot.robots[0].grasped_points.numpy()
    np.testing.assert_array_equal(floats[f:f + 3 * NGP].reshape(28, 3),
                                  np.concatenate([gp, gp]))
    # the mutual rows of the grasped points: 14 x (5 + 6) beside the
    # links' 5 x (5 + 6) and the second Panda's 5 x 6
    assert K_mut == 19 * 5 + 19 * 6 + 5 * 6
    assert mr_shared_bytes(ints) == 4 * 32 * (3 * P + 6 * D + n_bp)
    assert mr_shared_bytes(ints) <= SMEM_MAX


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
    n0 = a["P"] - a["G"]
    for p in range(a["P"]):
        li = a["point_link"][p]
        if p < n0:
            np.testing.assert_array_equal(plain[p], t_w[li].numpy())
            continue
        x = offset_point_model(R_w[li].numpy(), t_w[li].numpy(),
                               a["pt_off"][3 * (p - n0):3 * (p - n0) + 3])
        np.testing.assert_array_equal(x, plain[p])


def model_terms(ints, floats, q):
    """g (D, N), Hqq (D, D, N), cost (N) computed as terms.cu computes
    them, in float64, from the packed buffers alone."""
    a = terms_sections(ints, floats)
    fl = {k: np.asarray(v, np.float64) for k, v in a.items()
          if isinstance(v, np.ndarray) and v.dtype == F32}
    q = q.astype(np.float64)
    N, D, P, G = q.shape[1], a["D"], a["P"], a["G"]
    Rw, tw = {}, {}
    for i in a["topo"]:
        F = fl["frot"][9 * i:9 * i + 9].reshape(3, 3)
        tr = np.repeat(fl["trans"][3 * i:3 * i + 3, None], N, 1)
        if a["jtype"][i] in (1, 2):
            qi = q[a["qidx"][i]]
            if a["jtype"][i] == 1:
                qi = np.clip(qi, fl["clo"][i], fl["chi"][i])
            Rl = np.einsum("ab,bcn->acn", F, _rodrigues(
                fl["axis"][3 * i:3 * i + 3], qi))
        else:
            Rl = np.repeat(F[:, :, None], N, 2)
        p = a["parent"][i]
        if p < 0:
            Rw[i], tw[i] = Rl, tr
        else:
            Rw[i] = np.einsum("abn,bcn->acn", Rw[p], Rl)
            tw[i] = np.einsum("abn,bn->an", Rw[p], tr) + tw[p]
    z, o = [], []
    for j in range(D):
        li = a["ctrl"][j]
        in_lim = (q[j] >= fl["clo"][li]) & (q[j] <= fl["chi"][li])
        z.append(np.einsum("abn,b->an", Rw[li], fl["axis"][3 * li:3 * li + 3])
                 * in_lim)
        o.append(tw[li])
    pts = []
    for p in range(P):
        li = a["point_link"][p]
        off = p - (P - G)
        pts.append(tw[li] if off < 0 else np.einsum(
            "abn,b->an", Rw[li], fl["pt_off"][3 * off:3 * off + 3]) + tw[li])

    def jac(p, j):
        if not (a["anc"][p] >> j) & 1:
            return np.zeros((3, N))
        return np.cross(z[j], pts[p] - o[j], axis=0)

    g, H, cost = np.zeros((D, N)), np.zeros((D, D, N)), np.zeros(N)

    def add(r, Jr):
        nonlocal cost
        cost = cost + r * r
        g[:] += r * Jr
        H[:] += Jr[:, None] * Jr[None]

    act = lambda r: (r > 0).astype(np.float64)          # noqa: E731
    scene_i = (a["obj_group_begin"], a["group_kind"], a["group_count"],
               a["group_off"])
    scene_f = (fl["obj_rot"].reshape(-1, 9), fl["obj_pos"].reshape(-1, 3),
               fl["prims"])
    rows = []
    for mi in range(a["NO"]):
        p = a["obj_pt"][mi]
        rows.append((p, *_scene_sdf_grad(scene_i, scene_f, pts[p],
                                         a["NOBJ"], a["NG"]), mi))
    for mi in range(a["NO"]):
        p = a["obj_pt"][mi]
        x = pts[p]
        faces = np.concatenate([x - fl["ws_min"][:, None],
                                fl["ws_max"][:, None] - x])
        fi = np.argmin(faces, 0)
        wgrad = np.stack([np.where(fi == k, 1.0, 0.0)
                          - np.where(fi == k + 3, 1.0, 0.0) for k in range(3)])
        rows.append((p, faces.min(0), wgrad, mi))
    for p, val, grad, mi in rows:
        r = np.maximum(fl["obj_thresh"][mi] - val, 0.0)
        add(r, np.stack([-act(r) * (grad * jac(p, j)).sum(0)
                         for j in range(D)]))
    for k in range(a["K"]):
        pa, pb = a["pair_a"][k], a["pair_b"][k]
        diff = pts[pa] - pts[pb]
        dist = np.sqrt((diff * diff).sum(0))
        r = np.maximum(fl["pair_margin"][k] - dist, 0.0)
        u = diff / dist
        add(r, np.stack([-act(r) * (u * (jac(pa, j) - jac(pb, j))).sum(0)
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
    got = model_cost(*pack_cost_params(lay), q)
    _hold([got], [ref[2]], "cost")


def test_multirobot_models_on_the_buffers_match_plain(multirobot):
    task, lay = multirobot
    lo, hi = task.robot.q_min.numpy(), task.robot.q_max.numpy()
    q = _rand_q(lo, hi, 128, seed=3)
    ref = task.collision_residuals.obstacle_terms_lanes.plain.unscaled(
        torch.as_tensor(q))
    _hold(model_mr_terms(*pack_multirobot_params(lay), q), ref, "mr terms")
    _hold([model_cost(*pack_cost_params(lay), q)], [ref[2]], "mr cost")
