"""The port's UR10, MultiRobot and MultiRobot GN terms (plain version of the
CUDA MultiRobot terms kernel) vs the JAX package on the same numpy inputs.

Embodiments: the config-4 three-arm robot (benchmarks/run_all.py:
Panda, Panda, UR10 at their base poses, EnvSpheres3D, cutoff 0.02) and the
two-arm shape of tests/test_pallas_terms.py (Panda and UR10 0.55 m apart).

Tolerances: terms as tests/test_pallas_terms.py holds JAX's MultiRobot
kernel, atol 3e-5 * max|ref| plus rtol 2e-5 (float32 sums in another
order); FK, points and Jacobians atol 1e-5 (metres), as
tests/test_torch_kin.py; UR10 link poses against the golden file at the
JAX package's own 2e-5 (tests/test_kin_fk.py); the kernel model in float64
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
from torch_robotics_tpu_torch.ops.terms_kernel import (mr_shared_bytes,
                                                       pack_multirobot_params)
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
    reference assembles it through its generic padded path, which is not
    ported, so building the terms raises."""
    arrays = task_arrays(port_task(TWO_ARM))
    arrays["self_pair_idxs"] = np.concatenate(
        [arrays["self_pair_idxs"], [[0, 1]]])
    arrays["self_margins"] = np.concatenate(
        [arrays["self_margins"], np.float32([0.2])])
    with pytest.raises(NotImplementedError, match="same member"):
        task_from_numpy(arrays, device="cpu")


# ----------------------------------------------------------------------
# a float64 model of mr_terms.cu, reading only the packed buffers
# ----------------------------------------------------------------------
def _rodrigues(axis, q):
    c, s = np.cos(q), np.sin(q)
    ax, ay, az = axis
    oc = 1.0 - c
    return np.stack([1 + oc * (ax * ax - 1), -s * az + oc * ax * ay,
                     s * ay + oc * ax * az, s * az + oc * ax * ay,
                     1 + oc * (ay * ay - 1), -s * ax + oc * ay * az,
                     -s * ay + oc * ax * az, s * ax + oc * ay * az,
                     1 + oc * (az * az - 1)]).reshape(3, 3, -1)


def _scene_sdf_grad(ip, fp_scene, x, NOBJ, NG):
    """Min-over-spheres SDF and gradient at x (3, N) (the EnvSpheres3D
    scene: every group holds spheres)."""
    obj_begin, kind, count, off = ip
    rot, pos, prims = fp_scene
    best = np.full(x.shape[1], np.inf)
    grad = np.zeros_like(x)
    for o in range(NOBJ):
        R = rot[o].reshape(3, 3)
        xo = R.T @ (x - pos[o][:, None])
        for g in range(obj_begin[o], obj_begin[o + 1]):
            assert kind[g] == 0
            for j in range(count[g]):
                c = prims[off[g] + 4 * j: off[g] + 4 * j + 3]
                d = xo - c[:, None]
                dist = np.sqrt((d * d).sum(0))
                s = dist - prims[off[g] + 4 * j + 3]
                take = s < best
                best = np.where(take, s, best)
                grad = np.where(take, R @ (d / dist), grad)
    return best, grad


def _act(r):
    return (r > 0).astype(np.float64)


def model_mr_terms(ints, floats, q):
    """g (d, N), Hqq (d, d, N), cost (N) computed as mr_terms.cu computes
    them, from the packed buffers alone."""
    n_mem, D, P, NO, K_own, K_mut, NOBJ, NG, n_bp, L_sum, _, NGP = ints[:12]
    pos = [16]

    def take(n, arr):
        out = arr[pos[0]:pos[0] + n]
        pos[0] += n
        return out
    sec = {}
    for key in ("mem_L", "mem_D", "mem_doff", "mem_loff", "mem_obj_begin",
                "mem_obj_end", "mem_own_begin", "mem_own_end"):
        sec[key] = take(n_mem, ints)
    for key in ("bp_i", "bp_j", "bp_begin", "bp_end"):
        sec[key] = take(n_bp, ints)
    for key in ("topo", "parent", "jtype", "qidx"):
        sec[key] = take(L_sum, ints)
    sec["ctrl"] = take(D, ints)
    for key in ("pt_member", "pt_link", "pt_anc", "pt_goff"):
        sec[key] = take(P, ints)
    for key, n in (("own_a", K_own), ("own_b", K_own), ("mut_a", K_mut),
                   ("mut_b", K_mut), ("obj_group_begin", NOBJ + 1),
                   ("group_kind", NG), ("group_count", NG),
                   ("group_off", NG)):
        sec[key] = take(n, ints)
    pos[0] = 0
    fl = {}
    for key, n in (("trans", 3 * L_sum), ("frot", 9 * L_sum),
                   ("axis", 3 * L_sum), ("clo", L_sum), ("chi", L_sum),
                   ("base_R", 9 * n_mem), ("base_t", 3 * n_mem),
                   ("obj_thresh", NO), ("own_margin", K_own),
                   ("mut_margin", K_mut), ("ws_min", 3), ("ws_max", 3),
                   ("goff", 3 * NGP), ("obj_rot", 9 * NOBJ),
                   ("obj_pos", 3 * NOBJ)):
        fl[key] = take(n, floats).astype(np.float64)
    fl["prims"] = floats[pos[0]:].astype(np.float64)
    q = q.astype(np.float64)
    N = q.shape[1]

    # phase 1: per member FK -> world points, joint axes and origins
    pts = np.zeros((P, 3, N))
    z = np.zeros((D, 3, N))
    o = np.zeros((D, 3, N))
    for w in range(n_mem):
        lo, doff = sec["mem_loff"][w], sec["mem_doff"][w]
        Rw, tw = {}, {}
        for ii in range(sec["mem_L"][w]):
            i = sec["topo"][lo + ii]
            li = lo + i
            F = fl["frot"][9 * li:9 * li + 9].reshape(3, 3)
            tr = np.repeat(fl["trans"][3 * li:3 * li + 3, None], N, 1)
            jt = sec["jtype"][li]
            if jt in (1, 2):
                qi = q[doff + sec["qidx"][li]]
                if jt == 1:
                    qi = np.clip(qi, fl["clo"][li], fl["chi"][li])
                Rl = np.einsum("ab,bcn->acn", F, _rodrigues(
                    fl["axis"][3 * li:3 * li + 3], qi))
            else:
                assert jt == 0
                Rl = np.repeat(F[:, :, None], N, 2)
            p = sec["parent"][li]
            if p < 0:
                Rw[i], tw[i] = Rl, tr
            else:
                Rw[i] = np.einsum("abn,bcn->acn", Rw[p], Rl)
                tw[i] = np.einsum("abn,bn->an", Rw[p], tr) + tw[p]
        Rb = fl["base_R"][9 * w:9 * w + 9].reshape(3, 3)
        tb = fl["base_t"][3 * w:3 * w + 3, None]
        for c in range(sec["mem_D"][w]):
            li = sec["ctrl"][doff + c]
            gl = lo + li
            qc = q[doff + c]
            in_lim = (qc >= fl["clo"][gl]) & (qc <= fl["chi"][gl])
            z[doff + c] = np.einsum("ab,bcn,c->an", Rb, Rw[li],
                                    fl["axis"][3 * gl:3 * gl + 3]) * in_lim
            o[doff + c] = Rb @ tw[li] + tb
        for p in range(P):
            if sec["pt_member"][p] == w:
                li, go = sec["pt_link"][p], sec["pt_goff"][p]
                x = tw[li] if go < 0 else (np.einsum(
                    "abn,b->an", Rw[li], fl["goff"][3 * go:3 * go + 3])
                    + tw[li])
                pts[p] = Rb @ x + tb

    def jac(m, p, c):
        if not (sec["pt_anc"][p] >> c) & 1:
            return np.zeros((3, N))
        col = sec["mem_doff"][m] + c
        return np.cross(z[col], pts[p] - o[col], axis=0)

    def pair(pa, pb, margin):
        diff = pts[pa] - pts[pb]
        dist = np.sqrt((diff * diff).sum(0))
        return np.maximum(margin - dist, 0.0), diff / dist

    g = np.zeros((D, N))
    H = np.zeros((D, D, N))
    cost = np.zeros(N)
    scene_i = (sec["obj_group_begin"], sec["group_kind"], sec["group_count"],
               sec["group_off"])
    scene_f = (fl["obj_rot"].reshape(-1, 9), fl["obj_pos"].reshape(-1, 3),
               fl["prims"])
    for b in range(n_bp):
        bi, bj = sec["bp_i"][b], sec["bp_j"][b]
        if bi == bj:
            m, dm, doff = bi, sec["mem_D"][bi], sec["mem_doff"][bi]
            sl = slice(doff, doff + dm)

            def add(r, Jr):
                g[sl] += r * Jr
                H[sl, sl] += Jr[:, None] * Jr[None]

            for p in range(sec["mem_obj_begin"][m], sec["mem_obj_end"][m]):
                x = pts[p]
                val, grad = _scene_sdf_grad(scene_i, scene_f, x, NOBJ, NG)
                faces = np.concatenate([x - fl["ws_min"][:, None],
                                        fl["ws_max"][:, None] - x])
                fi = np.argmin(faces, 0)
                wgrad = np.stack([np.where(fi == k, 1.0, 0.0)
                                  - np.where(fi == k + 3, 1.0, 0.0)
                                  for k in range(3)])
                for v, gr in ((val, grad), (faces.min(0), wgrad)):
                    r = np.maximum(fl["obj_thresh"][p] - v, 0.0)
                    cost += r * r
                    add(r, np.stack([-_act(r) * (gr * jac(m, p, c)).sum(0)
                                     for c in range(dm)]))
            for k in range(sec["mem_own_begin"][m], sec["mem_own_end"][m]):
                pa, pb = sec["own_a"][k], sec["own_b"][k]
                r, u = pair(pa, pb, fl["own_margin"][k])
                cost += r * r
                add(r, np.stack([-_act(r) * (u * (jac(m, pa, c)
                                                  - jac(m, pb, c))).sum(0)
                                 for c in range(dm)]))
            for b2 in range(n_mem, n_bp):
                first = sec["bp_i"][b2] == m
                if not first and sec["bp_j"][b2] != m:
                    continue
                for k in range(sec["bp_begin"][b2], sec["bp_end"][b2]):
                    pa, pb = sec["mut_a"][k], sec["mut_b"][k]
                    r, u = pair(pa, pb, fl["mut_margin"][k])
                    p_side, sign = (pa, -1.0) if first else (pb, 1.0)
                    add(r, np.stack([sign * _act(r) * (u * jac(m, p_side, c))
                                     .sum(0) for c in range(dm)]))
        else:
            oi, oj = sec["mem_doff"][bi], sec["mem_doff"][bj]
            di, dj = sec["mem_D"][bi], sec["mem_D"][bj]
            for k in range(sec["bp_begin"][b], sec["bp_end"][b]):
                pa, pb = sec["mut_a"][k], sec["mut_b"][k]
                r, u = pair(pa, pb, fl["mut_margin"][k])
                cost += r * r
                A = np.stack([-_act(r) * (u * jac(bi, pa, c)).sum(0)
                              for c in range(di)])
                Bv = np.stack([_act(r) * (u * jac(bj, pb, c)).sum(0)
                               for c in range(dj)])
                cross = A[:, None] * Bv[None]
                H[oi:oi + di, oj:oj + dj] += cross
                H[oj:oj + dj, oi:oi + di] += cross.transpose(1, 0, 2)
    return g, H, 0.5 * cost


def test_packed_buffers_reproduce_the_plain_terms(tasks):
    """The buffers the CUDA MultiRobot kernel reads, run through a float64
    model of its two phases, give the plain terms; the shared-memory size
    follows the header."""
    _, _, ptask = tasks
    terms = ptask.collision_residuals.obstacle_terms_lanes
    ints, floats = pack_multirobot_params(terms.plain.layout)
    P, D, n_bp = int(ints[2]), int(ints[1]), int(ints[8])
    assert mr_shared_bytes(ints) == 4 * 32 * (3 * P + 6 * D + n_bp)
    for lo, hi, seed in ((0.3, 0.7, 8), (-0.2, 1.2, 9)):
        q = rand_q(ptask.robot, 24, seed=seed, lo=lo, hi=hi)
        got = model_mr_terms(ints, floats, q)
        ref = terms.plain.unscaled(torch.as_tensor(q))
        assert float(ref[2].abs().max()) > 0
        for a, r in zip(got, ref):
            r = r.double().numpy()
            np.testing.assert_allclose(a, r, atol=3e-5 * np.abs(r).max(),
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
