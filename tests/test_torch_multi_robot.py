"""The port's UR10, MultiRobot and MultiRobot GN terms (plain version of the
CUDA MultiRobot terms kernel) vs the JAX package on the same numpy inputs.

Embodiments: the config-4 three-arm robot (benchmarks/run_all.py:
Panda, Panda, UR10 at their base poses, EnvSpheres3D, cutoff 0.02) and the
two-arm shape of tests/test_pallas_terms.py (Panda and UR10 0.55 m apart).

Tolerances: terms as tests/test_pallas_terms.py holds JAX's MultiRobot
kernel, atol 3e-5 * max|ref| plus rtol 2e-5 (float32 sums in another
order); FK, points and Jacobians atol 1e-5 (metres), as
tests/test_torch_kin.py; UR10 link poses against the golden file at the
JAX package's own 2e-5 (tests/test_kin_fk.py); the kernel model
(``model_mr_terms``, on ``pack_multirobot_params``' buffers) in float64
against the float32 plain terms at the terms tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import load_golden
from test_torch_kin import _JAX_GROUP_FIELDS, _assert_arrays_equal
from torch_robotics_tpu.core import z_rot as jz_rot
from torch_robotics_tpu.envs import EnvSpheres3D as JEnvSpheres3D
from torch_robotics_tpu.ops.lanes_fk import \
    fk_positions_lanes as jax_fk_positions_lanes
from torch_robotics_tpu.ops.lanes_fk import \
    obstacle_terms_lanes_multirobot_factory as jax_mr_terms_factory
from torch_robotics_tpu.ops.pallas_terms import \
    obstacle_terms_pallas_factory as jax_pallas_terms_factory
from torch_robotics_tpu.robots import MultiRobot as JMultiRobot
from torch_robotics_tpu.robots import RobotPanda as JRobotPanda
from torch_robotics_tpu.robots import RobotUR10 as JRobotUR10
from torch_robotics_tpu.tasks import PlanningTask as JPlanningTask
from torch_robotics_tpu_torch.convert import task_arrays, task_from_numpy
from torch_robotics_tpu_torch.core import z_rot
from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.kin import fk_all_links, robot_zoo
from torch_robotics_tpu_torch.ops.lanes_fk import fk_positions_lanes
from torch_robotics_tpu_torch.ops.lanes_fk import \
    obstacle_terms_lanes_multirobot_factory as port_mr_terms_factory
from torch_robotics_tpu_torch.ops.terms_kernel import (
    mr_terms_launch_config, pack_multirobot_params)
from torch_robotics_tpu_torch.robots import (MultiRobot, RobotPanda,
                                             RobotUR10)
from torch_robotics_tpu_torch.tasks import PlanningTask

# base poses (x, y) and yaw of each member
CONFIG4 = (("panda", (0.2, 0.72), 0.0), ("panda", (0.2, -0.72), np.pi),
           ("ur10", (-0.75, 0.0), 0.0))
TWO_ARM = (("panda", (0.2, 0.55), 0.0), ("ur10", (0.2, -0.55), np.pi))
EMBODIMENTS = {"config4": CONFIG4, "two_arm": TWO_ARM}


def export_jax_multirobot_task(task):
    """A JAX MultiRobot PlanningTask's parameters as numpy arrays, in the
    format of torch_robotics_tpu_torch.convert.task_from_numpy."""
    robot = task.robot
    members = []
    for r in robot.robots:
        model = r.model
        m = {k: np.asarray(getattr(model, k)) for k in (
            "joint_trans", "joint_fixed_rot", "joint_axis", "clamp_lower",
            "clamp_upper", "q_lower", "q_upper")}
        m.update(
            joint_types=np.asarray(model.joint_types, np.int32),
            parent_idx=np.asarray(model.parent_idx, np.int32),
            q_map=np.asarray(model.q_map, np.int32),
            link_names=list(model.link_names),
            object_coll_idxs=np.asarray(r.object_coll_idxs, np.int32),
            self_coll_idxs=np.asarray(r.self_coll_idxs, np.int32),
            self_pair_idxs=np.asarray(r.self_pair_idxs,
                                      np.int32).reshape(-1, 2),
            object_margins=np.asarray(r.object_margins),
            self_margins=np.asarray(r.self_margins))
        members.append(m)
    out = dict(members=members, base_rots=np.asarray(robot.base_rots),
               base_trans=np.asarray(robot.base_trans),
               self_pair_idxs=np.asarray(robot.self_pair_idxs,
                                         np.int32).reshape(-1, 2),
               self_margins=np.asarray(robot.self_margins),
               ws_limits=np.asarray(task.ws_limits),
               obstacle_cutoff_margin=np.float64(
                   task.obstacle_cutoff_margin), objects=[])
    for obj in task.df_obj_list:
        groups = []
        for f in obj.fields:
            kind, names = _JAX_GROUP_FIELDS[type(f).__name__]
            groups.append({"kind": kind, **{n: np.asarray(getattr(f, n))
                                            for n in names}})
        out["objects"].append({"pos": np.asarray(obj.pos),
                               "ori": np.asarray(obj.ori), "groups": groups})
    return out


def jax_task(spec):
    make = {"panda": JRobotPanda.create, "ur10": JRobotUR10}
    poses = [(jz_rot(jnp.array(yaw, jnp.float32)),
              jnp.array([x, y, 0.0], jnp.float32))
             for _, (x, y), yaw in spec]
    robot = JMultiRobot.create([make[k]() for k, _, _ in spec], poses)
    return JPlanningTask(env=JEnvSpheres3D(), robot=robot,
                         obstacle_cutoff_margin=0.02)


def port_task(spec, device="cpu"):
    make = {"panda": lambda: RobotPanda.create(device=device),
            "ur10": lambda: RobotUR10(device=device)}
    poses = [(z_rot(torch.tensor(yaw, dtype=torch.float32)),
              torch.tensor([x, y, 0.0])) for _, (x, y), yaw in spec]
    robot = MultiRobot.create([make[k]() for k, _, _ in spec], poses)
    return PlanningTask(env=EnvSpheres3D(device=device), robot=robot,
                        obstacle_cutoff_margin=0.02)


@pytest.fixture(scope="module", params=sorted(EMBODIMENTS))
def tasks(request):
    jtask = jax_task(EMBODIMENTS[request.param])
    return request.param, jtask, task_from_numpy(
        export_jax_multirobot_task(jtask), device="cpu")


def rand_q(robot, n, seed, lo=0.0, hi=1.0):
    """q (d, n) uniform over [lo, hi] of each joint's range."""
    rng = np.random.default_rng(seed)
    q_lo, q_hi = robot.q_min.numpy(), robot.q_max.numpy()
    u = rng.uniform(lo, hi, size=(q_lo.shape[0], n))
    return (q_lo[:, None] + u * (q_hi - q_lo)[:, None]).astype(np.float32)


def _close_terms(got, ref, name=""):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=3e-5 * float(np.abs(r).max()),
                                   rtol=2e-5, err_msg=name)


def test_ur10_fk_matches_golden_and_jax():
    model = robot_zoo.ur10(device="cpu")
    jmodel = JRobotUR10().model
    g = load_golden("ur10_fk")
    assert list(model.link_names) == g["link_names"]
    H = fk_all_links(model, torch.as_tensor(g["q"])).numpy()
    np.testing.assert_allclose(H, g["link_tensor"], atol=2e-5)
    for k in ("joint_trans", "joint_fixed_rot", "joint_axis", "clamp_lower",
              "clamp_upper", "q_lower", "q_upper", "q_map"):
        np.testing.assert_array_equal(getattr(model, k),
                                      np.asarray(getattr(jmodel, k)))
    rng = np.random.default_rng(0)
    q = rng.uniform(-4.0, 4.0, size=(3, 5, 6)).astype(np.float32)
    np.testing.assert_allclose(
        fk_positions_lanes(model, torch.as_tensor(q)).numpy(),
        np.asarray(jax_fk_positions_lanes(jmodel, jnp.asarray(q))),
        atol=1e-5)


def test_task_arrays_round_trip(tasks):
    """The JAX task's exported arrays, the port's own task built from the
    URDFs, and the task rebuilt from the arrays are the same arrays."""
    name, jtask, ptask = tasks
    exported = export_jax_multirobot_task(jtask)
    own = task_arrays(port_task(EMBODIMENTS[name]))
    _assert_arrays_equal({k: v for k, v in exported.items() if k != "members"},
                         {k: v for k, v in own.items() if k != "members"})
    for a, b in zip(exported["members"], own["members"], strict=True):
        _assert_arrays_equal(a, b)
    rebuilt = task_arrays(ptask)
    for a, b in zip(exported["members"], rebuilt["members"], strict=True):
        _assert_arrays_equal(a, b)


def test_layout_points_and_jacobians_match_jax(tasks):
    name, jtask, ptask = tasks
    robot, jrobot = ptask.robot, jtask.robot
    if name == "config4":
        # 16 object points then self sections of 8 + 8 + 6; 26 own pairs
        # and 85 mutual pairs; 143 rows
        assert (robot.q_dim, robot.obj_counts, robot.self_counts) == (
            20, (5, 5, 6), (8, 8, 6))
        assert len(robot.self_pair_idxs) == 26 + 85
    q = rand_q(robot, 6, seed=1, lo=-0.2, hi=1.2).T
    pts, J = robot.fk_map_collision_with_jac(torch.as_tensor(q))
    jpts, jJ = jrobot.fk_map_collision_with_jac(jnp.asarray(q))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-5)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=1e-5)
    np.testing.assert_allclose(
        robot.fk_map_collision(torch.as_tensor(q)).numpy(),
        np.asarray(jrobot.fk_map_collision(jnp.asarray(q))), atol=1e-5)


@pytest.mark.parametrize("h", [None, 4])
def test_plain_terms_match_jax_structured_terms(tasks, h):
    name, jtask, ptask = tasks
    q = rand_q(ptask.robot, 16, seed=2, lo=0.3, hi=0.7)
    ref = jax_mr_terms_factory(jtask)(jnp.asarray(q), 50.0, h=h)
    got = ptask.collision_residuals.obstacle_terms_lanes(
        torch.as_tensor(q), 50.0, h=h)
    _close_terms(got, ref, name)


def test_plain_terms_match_jax_kernel_in_interpret_mode():
    """JAX's MultiRobot Pallas kernel (interpret mode) at the two-arm shape
    of its own test, on the same q."""
    jtask = jax_task(TWO_ARM)
    ptask = task_from_numpy(export_jax_multirobot_task(jtask), device="cpu")
    q = rand_q(ptask.robot, 16, seed=3)
    kernel = jax_pallas_terms_factory(jtask)
    terms = ptask.collision_residuals.obstacle_terms_lanes
    for h in (None, 4):
        ref = kernel(jnp.asarray(q), 50.0, h=h, interpret=True)
        _close_terms(terms(torch.as_tensor(q), 50.0, h=h), ref, str(h))


def test_rows_match_jax_residuals_and_jacobian(tasks):
    """Residual values and Jacobians over the full layout, in the
    reference's row order."""
    _, jtask, ptask = tasks
    q = rand_q(ptask.robot, 8, seed=4, lo=0.3, hi=0.7).T
    res = ptask.collision_residuals
    r, J = res.residuals_and_jacobian(torch.as_tensor(q))
    jr, jJ = jtask.collision_residuals.residuals_and_jacobian(jnp.asarray(q))
    assert bool((r > 0).any())
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=1e-5)
    np.testing.assert_allclose(res(torch.as_tensor(q)).numpy(),
                               np.asarray(jtask.collision_residuals(
                                   jnp.asarray(q))), atol=1e-5)
    # the value-only cost hook: its plain version on the CPU, 0.5 sum r^2
    q_cols = torch.as_tensor(q).T.contiguous()
    cost = res.collision_cost_lanes(q_cols)
    assert torch.equal(cost, res.collision_cost_lanes.plain(q_cols))
    np.testing.assert_allclose(cost.numpy(),
                               0.5 * np.sum(r.numpy() ** 2, axis=-1),
                               rtol=1e-5,
                               atol=1e-6 * float(cost.abs().max()))


def test_collision_checks_match_jax(tasks):
    _, jtask, ptask = tasks
    q = rand_q(ptask.robot, 512, seed=5).T
    got = ptask._compute_collision(torch.as_tensor(q)).numpy()
    ref = np.asarray(jtask._compute_collision(jnp.asarray(q)))
    np.testing.assert_array_equal(got, ref)
    trajs = rand_q(ptask.robot, 4 * 6 * 2, seed=6, lo=0.4, hi=0.6).T.reshape(
        4, 6, -1)
    trajs[..., 20:] = 0.0
    got_t, got_w = ptask.trajs_collision_masks(torch.as_tensor(trajs))
    ref_t, ref_w = jtask.trajs_collision_masks(jnp.asarray(trajs))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))


def test_cpu_tensors_take_the_plain_version(tasks):
    _, _, ptask = tasks
    terms = ptask.collision_residuals.obstacle_terms_lanes
    q = torch.as_tensor(rand_q(ptask.robot, 8, seed=7))
    for a, b in zip(terms(q, 3.0, h=2), terms.plain(q, 3.0, h=2)):
        assert torch.equal(a, b)


def test_same_member_mutual_pair_is_refused():
    """A mutual pair between two object points of one member: the
    block-structured assembly refuses it, as the reference's does (a
    ValueError when called strict; a warning in the reference's words when
    a task is built), and the task takes the generic padded assembly, as
    the reference falls back to it.  The task constructs, its plain terms
    are the generic assembly's (the structured factory's plain terms are
    none), and the kernel takes the pair on its member's diagonal block
    (tests/test_torch_mr_same_pair.py holds both against the JAX
    package)."""
    arrays = task_arrays(port_task(TWO_ARM))
    arrays["self_pair_idxs"] = np.concatenate(
        [arrays["self_pair_idxs"], [[0, 1]]])
    arrays["self_margins"] = np.concatenate(
        [arrays["self_margins"], np.float32([0.2])])
    with pytest.warns(UserWarning, match="same member 0; .* generic padded"):
        task = task_from_numpy(arrays, device="cpu")
    with pytest.raises(ValueError, match="same member"):
        port_mr_terms_factory(task)
    terms = task.collision_residuals.obstacle_terms_lanes
    k = len(arrays["self_pair_idxs"]) - 1
    assert terms.refusal is None
    assert terms.plain.layout.same_member == [(k, 0, 1, 0)]


# ----------------------------------------------------------------------
# a model of mr_terms.cu, reading only the packed buffers
# ----------------------------------------------------------------------
def _rodrigues(axis, q):
    c, s = np.cos(q), np.sin(q)
    ax, ay, az = axis
    oc = 1 - c
    return np.stack([1 + oc * (ax * ax - 1), -s * az + oc * ax * ay,
                     s * ay + oc * ax * az, s * az + oc * ax * ay,
                     1 + oc * (ay * ay - 1), -s * ax + oc * ay * az,
                     -s * ay + oc * ax * az, s * ax + oc * ay * az,
                     1 + oc * (az * az - 1)]).reshape(3, 3, -1)


def mr_sections(ints, floats):
    """``pack_multirobot_params``' buffers cut as mr_terms.cu cuts them: the
    members' cost packing (cost.cuh's parse_layout), then, from ints[13]
    on, the terms' sections; every int and float accounted for."""
    (n_mem, D, P, NO, K, NOBJ, NG, S, n_slots, T, n_prims, NGRID,
     NOFF) = (int(v) for v in ints[:13])
    a = dict(n_mem=n_mem, D=D, P=P, NO=NO, K=K, NOBJ=NOBJ, S=S,
             n_slots=n_slots)
    o = 16
    step_i = ints[o:o + 8 * S].reshape(S, 8)
    o += 8 * S
    for name, n in (("mem_step", n_mem + 1), ("pt_list", P), ("obj_pt", NO),
                    ("pair_a", K), ("pair_b", K), ("cuts", T + 1),
                    ("obj_group_begin", NOBJ + 1), ("group_kind", NG),
                    ("group_count", NG), ("group_off", NG),
                    ("obj_grid", NOBJ), ("grid_i", 4 * NGRID)):
        a[name], o = ints[o:o + n], o + n
    assert o == int(ints[13])
    n_bp, E = int(ints[o]), int(ints[o + 1])
    a.update(n_bp=n_bp, scratch=int(ints[o + 3]))
    o += 8
    # the value phase's row cuts: one range a warp of the block
    n_cuts = len(ints) - o - 2 * n_mem - 3 * n_bp - 1 - P - E
    for name, n in (("mem_D", n_mem), ("mem_doff", n_mem), ("bp_i", n_bp),
                    ("bp_j", n_bp), ("bp_begin", n_bp + 1),
                    ("vcuts", n_cuts), ("anc", P), ("entries", E)):
        a[name], o = ints[o:o + n], o + n
    assert o == len(ints)
    # the prismatic joints' columns, as the kernel reads them from the steps
    a["prism"] = sum(1 << int(c) for t, c in zip(step_i[:, 0], step_i[:, 1])
                     if t == 3 and c >= 0)
    a["prims"], o = floats[:n_prims], n_prims
    objects = floats[o:o + 12 * NOBJ].reshape(NOBJ, 12)
    o += 12 * NOBJ + 8 * NGRID
    step_f = floats[o:o + 20 * S].reshape(S, 20)
    o += 20 * S
    a["offsets"] = floats[o:o + 4 * NOFF].reshape(NOFF, 4)
    o += 4 * NOFF
    for name, n in (("base_R", 9 * n_mem), ("base_t", 3 * n_mem),
                    ("obj_thresh", NO), ("pair_margin", K), ("ws_min", 3),
                    ("ws_max", 3)):
        a[name], o = floats[o:o + n], o + n
    assert o == len(floats)
    a.update(jtype=step_i[:, 0], qcol=step_i[:, 1], src=step_i[:, 2],
             slot=step_i[:, 3], pt_begin=step_i[:, 4], pt_end=step_i[:, 5],
             n_off=step_i[:, 6], off_begin=step_i[:, 7], frot=step_f[:, :9],
             trans=step_f[:, 9:12], axis=step_f[:, 12:15],
             clo=step_f[:, 15], chi=step_f[:, 16], obj_rot=objects[:, :9],
             obj_pos=objects[:, 9:])
    return a


def model_mr_terms(ints, floats, q, dtype=np.float64, every_row=False):
    """g (D, N), Hqq (D, D, N), cost (N) computed as mr_terms.cu computes
    them from the packed buffers alone, in ``dtype`` (float32: each
    operation rounded): each member's FK steps from its own root, the base
    pose applied to the axes, origins and points; every row's value; then
    each block pair's row entries in their order, a row adding its
    Jacobian's g and H terms in the lanes where it is active (r != 0), or
    with ``every_row`` in every lane (an inactive row then adds +-0).  The
    scene's objects are spheres."""
    a = mr_sections(ints, floats)
    t_ = np.dtype(dtype).type
    q = q.astype(dtype)
    N, D, P = q.shape[1], a["D"], a["P"]
    c_ = lambda v: np.asarray(v, dtype)                # noqa: E731
    pts = np.zeros((P, 3, N), dtype)
    zo = np.zeros((D, 2, 3, N), dtype)                 # axis, origin
    for m in range(a["n_mem"]):
        Rb = c_(a["base_R"][9 * m:9 * m + 9]).reshape(3, 3)
        tb = c_(a["base_t"][3 * m:3 * m + 3])
        slots, R, t = {}, None, None
        for s in range(a["mem_step"][m], a["mem_step"][m + 1]):
            F = c_(a["frot"][s]).reshape(3, 3)
            tr = np.repeat(c_(a["trans"][s])[:, None], N, 1)
            qc, jt = a["qcol"][s], a["jtype"][s]
            lo, hi = t_(a["clo"][s]), t_(a["chi"][s])
            if jt in (1, 2):
                qi = q[qc] if jt == 2 else np.clip(q[qc], lo, hi)
                Rl = np.einsum("ab,bcn->acn", F,
                               _rodrigues(c_(a["axis"][s]), qi))
            else:
                Rl = np.repeat(F[:, :, None], N, 2)
                if jt == 3:
                    tr = tr + c_(a["axis"][s])[:, None] * np.clip(q[qc], lo,
                                                                  hi)
            if a["src"][s] == -1:              # the member's own root
                R, t = Rl, tr
            else:
                Rp, tp = (R, t) if a["src"][s] == -2 else slots[a["src"][s]]
                R = np.einsum("abn,bcn->acn", Rp, Rl)
                t = np.einsum("abn,bn->an", Rp, tr) + tp
            if a["slot"][s] >= 0:
                slots[a["slot"][s]] = (R, t)
            x = np.einsum("ab,bn->an", Rb, t) + tb[:, None]
            RwW = np.einsum("ab,bcn->acn", Rb, R)
            if qc >= 0:
                in_lim = ((q[qc] >= lo) & (q[qc] <= hi)).astype(dtype)
                zo[qc, 0] = np.einsum("abn,b->an", RwW,
                                      c_(a["axis"][s])) * in_lim
                zo[qc, 1] = x
            first_off = a["pt_end"][s] - a["n_off"][s]
            for i in range(a["pt_begin"][s], a["pt_end"][s]):
                pts[a["pt_list"][i]] = x if i < first_off else (
                    np.einsum("abn,b->an", RwW, c_(a["offsets"][
                        a["off_begin"][s] + i - first_off, :3])) + x)

    n_sdf = a["NO"] if a["NOBJ"] > 0 else 0
    ws_min, ws_max = c_(a["ws_min"])[:, None], c_(a["ws_max"])[:, None]

    def sdf(x):
        """Min-over-spheres SDF and the first minimum's gradient."""
        best = np.full(N, np.inf, dtype)
        grad = np.zeros((3, N), dtype)
        for o in range(a["NOBJ"]):
            Ro = c_(a["obj_rot"][o]).reshape(3, 3)
            xo = Ro.T @ (x - c_(a["obj_pos"][o])[:, None])
            for gr in range(a["obj_group_begin"][o],
                            a["obj_group_begin"][o + 1]):
                assert a["group_kind"][gr] in (0, 3)
                off = a["group_off"][gr]
                for j in range(a["group_count"][gr]):
                    ctr = c_(a["prims"][off + 4 * j:off + 4 * j + 4])
                    d = xo - ctr[:3, None]
                    dist = np.sqrt((d * d).sum(0))
                    take = dist - ctr[3] < best
                    best = np.where(take, dist - ctr[3], best)
                    grad = np.where(take, Ro @ (d / dist), grad)
        return best, grad

    def faces(x):
        f = np.concatenate([x - ws_min, ws_max - x])
        fi = np.argmin(f, 0)
        return f.min(0), np.stack([(fi == k).astype(dtype)
                                   - (fi == k + 3).astype(dtype)
                                   for k in range(3)])

    rs = []                                    # every row's value
    for r in range(n_sdf + a["NO"] + a["K"]):
        if r < n_sdf + a["NO"]:
            mi = r if r < n_sdf else r - n_sdf
            x = pts[a["obj_pt"][mi]]
            val = sdf(x)[0] if r < n_sdf else faces(x)[0]
            rs.append(np.maximum(t_(a["obj_thresh"][mi]) - val, 0))
        else:
            k = r - n_sdf - a["NO"]
            diff = pts[a["pair_a"][k]] - pts[a["pair_b"][k]]
            rs.append(np.maximum(t_(a["pair_margin"][k])
                                 - np.sqrt((diff * diff).sum(0)), 0))

    def jdot(doff, p, c, x, v):
        col = doff + c
        if not (a["anc"][p] >> c) & 1:
            return np.zeros(N, dtype)
        if (a["prism"] >> col) & 1:
            return (v * zo[col, 0]).sum(0)
        return (v * np.cross(zo[col, 0], x - zo[col, 1], axis=0)).sum(0)

    g, H = np.zeros((D, N), dtype), np.zeros((D, D, N), dtype)
    cost = np.zeros(N, dtype)
    for w in range(a["n_bp"]):
        i, j = a["bp_i"][w], a["bp_j"][w]
        oi, oj = a["mem_doff"][i], a["mem_doff"][j]
        di, dj = a["mem_D"][i], a["mem_D"][j]
        acc = np.zeros(N, dtype)
        for e in a["entries"][a["bp_begin"][w]:a["bp_begin"][w + 1]]:
            row, flags = e >> 3, e & 7
            r = rs[row]
            if not flags & 4:
                acc = acc + r * r
            live = np.ones(N, bool) if every_row else r != 0
            act = (r > 0).astype(dtype)
            if row < n_sdf + a["NO"]:
                mi = row if row < n_sdf else row - n_sdf
                p = a["obj_pt"][mi]
                grad = (sdf if row < n_sdf else faces)(pts[p])[1]
                A = [-act * jdot(oi, p, c, pts[p], grad) for c in range(di)]
                B = None
            else:
                k = row - n_sdf - a["NO"]
                pa, pb = a["pair_a"][k], a["pair_b"][k]
                if flags & 1:
                    pa, pb = pb, pa
                diff = pts[pa] - pts[pb]
                u = diff / np.sqrt((diff * diff).sum(0))
                if i == j and not flags & 4:       # an own pair
                    A = [-act * (jdot(oi, pa, c, pts[pa], u)
                                 - jdot(oi, pb, c, pts[pb], u))
                         for c in range(di)]
                    B = None
                elif i == j:                       # a side of a mutual row
                    A = [act * jdot(oi, pb, c, pts[pb], u) if flags & 2
                         else -act * jdot(oi, pa, c, pts[pa], u)
                         for c in range(di)]
                    B = None
                else:
                    A = [-act * jdot(oi, pa, c, pts[pa], u)
                         for c in range(di)]
                    B = [act * jdot(oj, pb, c, pts[pb], u)
                         for c in range(dj)]
            if B is None:                          # g_i, H_ii
                for c1 in range(di):
                    g[oi + c1] = np.where(live, g[oi + c1] + r * A[c1],
                                          g[oi + c1])
                    for c2 in range(c1, di):
                        h = np.where(live, H[oi + c1, oi + c2]
                                     + A[c1] * A[c2], H[oi + c1, oi + c2])
                        H[oi + c1, oi + c2] = H[oi + c2, oi + c1] = h
            else:                                  # H_ij
                for c1 in range(di):
                    for c2 in range(dj):
                        h = np.where(live, H[oi + c1, oj + c2]
                                     + A[c1] * B[c2], H[oi + c1, oj + c2])
                        H[oi + c1, oj + c2] = H[oj + c2, oi + c1] = h
        cost = cost + acc
    return g, H, t_(0.5) * cost


def test_packed_buffers_reproduce_the_plain_terms(tasks):
    """The buffers the CUDA MultiRobot kernel reads, run through a float64
    model of its phases, give the plain terms; the block takes one warp a
    block pair and the shared memory its header says."""
    _, _, ptask = tasks
    terms = ptask.collision_residuals.obstacle_terms_lanes
    ints, floats = pack_multirobot_params(terms.plain.layout)
    a = mr_sections(ints, floats)
    n_rows = 2 * a["NO"] + a["K"]
    launch = mr_terms_launch_config(ints, len(floats))
    assert launch["threads"] == 32 * a["n_bp"] and launch["lanes"] == 32
    assert launch["smem_bytes"] == 4 * (
        -(-len(ints) // 4) * 4 + -(-len(floats) // 4) * 4 + 32 * (
            7 * a["D"] + 3 * a["P"] + 12 * a["n_slots"] + n_rows
            + a["n_bp"] + a["NO"]))
    for lo, hi, seed in ((0.3, 0.7, 8), (-0.2, 1.2, 9)):
        q = rand_q(ptask.robot, 24, seed=seed, lo=lo, hi=hi)
        got = model_mr_terms(ints, floats, q)
        ref = terms.plain.unscaled(torch.as_tensor(q))
        assert float(ref[2].abs().max()) > 0
        for a_, r in zip(got, ref):
            r = r.double().numpy()
            np.testing.assert_allclose(a_, r, atol=3e-5 * np.abs(r).max(),
                                       rtol=2e-5)


def test_axis_rotations_match_jax():
    from torch_robotics_tpu.core import x_rot as jx_rot
    from torch_robotics_tpu.core import y_rot as jy_rot
    from torch_robotics_tpu_torch.core import x_rot, y_rot
    a = np.random.default_rng(10).uniform(-3, 3, size=(4, 2)).astype(
        np.float32)
    for port, ref in ((x_rot, jx_rot), (y_rot, jy_rot), (z_rot, jz_rot)):
        np.testing.assert_allclose(port(torch.as_tensor(a)).numpy(),
                                   np.asarray(ref(jnp.asarray(a))),
                                   atol=1e-6)
