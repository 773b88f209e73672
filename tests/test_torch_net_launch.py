"""The learned self-collision row's CUDA launch shape and packed buffers on
the CPU: ``net_launch_config``'s route and tile from the widths and the
activation, within the card's limits, refusals for what ``net_row.cu``
does not take, the simt route's packed layout, a numpy model of the simt
kernel's arithmetic on those buffers held to the plain row and to JAX, the
net task's terms and cost kernels' packing with no pair rows, and the
wrappers' routes.  The tensor-core route's model and layout are in
test_torch_net_tc.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu_torch.envs import EnvSpheres3D
from torch_robotics_tpu_torch.ops.lanes_fk import TermsLayout
from torch_robotics_tpu_torch.ops.net_kernel import (NetRowParams,
                                                     _pack_simt,
                                                     add_net_cost,
                                                     add_net_terms,
                                                     net_launch_config,
                                                     net_rows,
                                                     pack_net_params)
from torch_robotics_tpu_torch.ops.terms_kernel import (cost_launch_config,
                                                       pack_cost_params,
                                                       pack_terms_params)
from torch_robotics_tpu_torch.robots import MultiRobot, RobotPanda
from torch_robotics_tpu_torch.tasks import PlanningTask

from test_torch_cost_schedule import model_cost
from test_torch_net_tc import model_net_row_tc
from test_torch_self_collision_net import (NPZ, box_q, jax_net, numpy_net,
                                           spread)

F32 = np.float32
SMEM_MAX, MAX_THREADS = 232448, 1024
BUNDLED = (7, 256, 128, 64, 1)
CUTOFF = 0.001
# wider nets (the simt route), whose shared memory takes 16, 8 and 4 lanes
# a block
WIDE = {16: (7, 1024, 1024, 1), 8: (7, 2048, 2048, 1), 4: (7, 4096, 4096, 1)}
# the tf32x3 packing of the bundled widths (floats) and a warp's scratch
# (terms kernel)
TC_FLOATS, TC_SCRATCH = 45272, 16 * 9 + 16 * 8 + 8 + 256 + 128 + 64


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_bundled_launch_shape_fits_the_card(activation):
    """The bundled widths take the tensor-core route: one block of 256
    threads a multiprocessor, 16 lanes a warp's tile for the terms kernel
    and 32 for the cost kernel, the packed net (and each warp's scratch
    for the terms kernel) in shared memory."""
    cfg = net_launch_config(BUNDLED, activation)
    assert cfg == dict(route="tf32x3", lanes=16, threads=256,
                       smem_bytes=4 * (TC_FLOATS + 8 * TC_SCRATCH),
                       cost_lanes=32, cost_smem_bytes=4 * TC_FLOATS)
    assert cfg["cost_smem_bytes"] <= SMEM_MAX
    assert cfg["smem_bytes"] <= SMEM_MAX and cfg["threads"] <= MAX_THREADS


@pytest.mark.parametrize("widths,activation,route", [
    (BUNDLED, "relu", "tf32x3"),
    (BUNDLED, "tanh", "tf32x3"),
    ((6, 256, 128, 64, 1), "relu", "tf32x3"),     # d <= 8 pads to 8
    ((8, 256, 128, 64, 1), "tanh", "tf32x3"),
    ((9, 256, 128, 64, 1), "relu", "simt"),       # d > 8
    ((7, 256, 128, 1), "relu", "simt"),           # other hidden widths
    ((7, 128, 128, 64, 1), "tanh", "simt"),
    ((7, 256, 128, 64, 32, 1), "relu", "simt"),
    ((7, 32, 16, 1), "relu", "simt"),
    (WIDE[16], "relu", "simt"),
    (WIDE[4], "tanh", "simt"),
])
def test_route_follows_the_widths(widths, activation, route):
    """The route comes from the widths and the activation alone, and the
    packing follows it (ints[3] is the route)."""
    cfg = net_launch_config(widths, activation)
    assert cfg["route"] == route
    assert cfg["smem_bytes"] <= SMEM_MAX and cfg["threads"] <= MAX_THREADS
    if route == "simt":
        return
    from torch_robotics_tpu_torch.costs import SelfCollisionNet
    net = SelfCollisionNet.from_arrays(numpy_net(list(widths), activation, 3),
                                       "cpu")
    ints, floats = pack_net_params(net, CUTOFF)
    assert int(ints[3]) == 1 and floats.size == TC_FLOATS


def test_wide_nets_take_fewer_lanes_or_raise():
    """The simt route: the lanes a block halve while 4 bytes x lanes x
    (padded widths but the output's, + 1) pass the card's shared memory."""
    for lanes, widths in list(WIDE.items()) + [(16, (7, 2048, 1024, 1))]:
        cfg = net_launch_config(widths)
        rows = sum(-(-w // 4) * 4 for w in widths[:-1]) + 1
        assert cfg == dict(route="simt", lanes=lanes, threads=256,
                           smem_bytes=4 * lanes * rows, cost_lanes=lanes,
                           cost_smem_bytes=4 * lanes * rows)
        assert 4 * 2 * lanes * rows > SMEM_MAX >= cfg["smem_bytes"]
    with pytest.raises(NotImplementedError):
        net_launch_config((7, 8192, 8192, 1))
    with pytest.raises(NotImplementedError):
        net_launch_config(BUNDLED, activation="sigmoid")
    with pytest.raises(NotImplementedError):
        net_launch_config((7, 1))                  # no hidden layer
    with pytest.raises(NotImplementedError):
        net_launch_config((7, 64, 2))              # not a scalar output


def _nets(q):
    """{kind: (port net, its arrays)}: the bundled net and relu / tanh
    spread nets of the bundled widths, active on about half of q (N, 7)."""
    from torch_robotics_tpu_torch.costs import SelfCollisionNet
    net = SelfCollisionNet.from_npz(NPZ, device="cpu")
    out = {"bundled": (net, net.arrays())}
    with np.load(NPZ) as data:
        for act in ("relu", "tanh"):
            arrays = spread(numpy_net(list(BUNDLED), act, seed=41,
                                      like=data), q)
            out[act + "_spread"] = (
                SelfCollisionNet.from_arrays(arrays, "cpu"), arrays)
    return out


def test_packed_layout():
    """The simt packing (of the bundled net, as the simt kernel would read
    it; a net routed to simt gets the same from pack_net_params)."""
    from torch_robotics_tpu_torch.costs import SelfCollisionNet
    net = SelfCollisionNet.from_npz(NPZ, device="cpu")
    ints, floats = _pack_simt(net, CUTOFF)
    assert ints.dtype == np.int32 and floats.dtype == np.float32
    assert ints.tolist() == [4, 0, 7, 0, 8, 256, 128, 64, 4]
    wp = [8, 256, 128, 64, 4]
    assert floats.size == 4 + 2 * 8 + sum(
        wp[i] * wp[i + 1] + wp[i + 1] for i in range(4))
    a = net.arrays()
    assert floats[:4].tolist() == [F32(a["scale_out"][0]),
                                   F32(a["scale_out"][1]), F32(CUTOFF), 0]
    assert floats[11] == 0 and floats[19] == 1       # mean / std padding
    W0 = floats[20:20 + 8 * 256].reshape(8, 256)
    assert np.array_equal(W0[:7], a["W0"]) and not W0[7].any()
    last = floats[-(64 * 4 + 4):]
    W3, b3 = last[:256].reshape(64, 4), last[256:]
    assert np.array_equal(W3[:, 0], a["W3"][:, 0]) and not W3[:, 1:].any()
    assert b3[0] == a["b3"][0] and not b3[1:].any()
    simt = SelfCollisionNet.from_arrays(numpy_net([7, 64, 32, 1], "relu", 5),
                                        "cpu")
    for got, want in zip(pack_net_params(simt, CUTOFF),
                         _pack_simt(simt, CUTOFF)):
        assert np.array_equal(got, want)


def model_net_row(ints, floats, q, lanes, g, H, cost, terms=True):
    """net_row.cu's arithmetic on its packed buffers, float32 numpy, tile
    by tile of ``lanes`` lanes: the same offsets, padding, sums in
    ascending order, the backward over the stored activations, and writes
    only for active lanes (in place into g (d, N), H (d, d, N), cost)."""
    L, act, d = int(ints[0]), int(ints[1]), int(ints[2])
    wp = [int(v) for v in ints[4:4 + L + 1]]
    scale, shift, cutoff = floats[0], floats[1], floats[2]
    mean, std = floats[4:4 + wp[0]], floats[4 + wp[0]:4 + 2 * wp[0]]
    off = 4 + 2 * wp[0]
    Ws, bs = [], []
    for i in range(L):
        Ws.append(floats[off:off + wp[i] * wp[i + 1]].reshape(wp[i],
                                                              wp[i + 1]))
        off += wp[i] * wp[i + 1]
        bs.append(floats[off:off + wp[i + 1]])
        off += wp[i + 1]
    assert off == floats.size
    f = (lambda v: np.maximum(v, F32(0))) if act == 0 else np.tanh
    df = (lambda h: (h > 0).astype(F32)) if act == 0 else (
        lambda h: (F32(1) - h * h).astype(F32))
    N = q.shape[1]
    for t0 in range(0, N, lanes):
        n = np.arange(t0, min(t0 + lanes, N))
        x = np.zeros((wp[0], lanes), F32)
        x[:d, :len(n)] = (q[:, n] - mean[:d, None]) / std[:d, None]
        hs = [x]
        for i in range(L - 1):
            hs.append(f((Ws[i].T @ hs[-1] + bs[i][:, None]).astype(F32))
                      .astype(F32))
        s = (Ws[-1][:, 0] @ hs[-1]).astype(F32)
        sd = -((s + bs[-1][0]) * scale + shift).astype(F32)
        r = np.maximum(cutoff - sd, F32(0)).astype(F32)[:len(n)]
        on = r > 0
        if not terms:
            cost[n[on]] += F32(0.5) * (r[on] * r[on])
            continue
        if not on.any():
            continue
        delta = (Ws[-1][:, :1] * df(hs[-1])).astype(F32)
        for i in range(L - 2, 0, -1):
            delta = ((Ws[i] @ delta) * df(hs[i])).astype(F32)
        gx = (Ws[0] @ delta).astype(F32)[:d, :len(n)]
        gq = ((-scale * gx) / std[:d, None]).astype(F32)
        Jr = -gq[:, on]
        g[:, n[on]] += r[on] * Jr
        H[:, :, n[on]] += Jr[:, None] * Jr[None]
        cost[n[on]] += F32(0.5) * (r[on] * r[on])


@pytest.mark.parametrize("lanes", [32, 8])
def test_kernel_model_matches_plain_and_jax(lanes):
    """The simt kernel's model on the simt packing of the bundled widths, at
    32 lanes a block and at a wider net's 8 (the model's tiling is the same
    code at any width), on a ragged N = 100 (the last tile partial): the
    model adds the
    plain row's contribution to within 2e-6 of max|ref| and leaves every
    inactive lane's g, H and cost bit for bit as they were; the plain row
    equals JAX's vjp of the same net."""
    q = box_q(100, seed=6)
    rng = np.random.default_rng(7)
    for kind, (net, arrays) in _nets(q).items():
        qc = np.ascontiguousarray(q.T)
        g0 = rng.normal(size=(7, 100)).astype(F32)
        H0 = rng.normal(size=(7, 7, 100)).astype(F32)
        c0 = np.abs(rng.normal(size=100)).astype(F32)
        ints, floats = _pack_simt(net, CUTOFF)
        g, H, c, c2 = g0.copy(), H0.copy(), c0.copy(), c0.copy()
        model_net_row(ints, floats, qc, lanes, g, H, c)
        model_net_row(ints, floats, qc, lanes, None, None, c2, terms=False)
        ref = [torch.as_tensor(a.copy()) for a in (g0, H0, c0)]
        add_net_terms(NetRowParams(net, CUTOFF, "cpu"), torch.as_tensor(qc),
                      *ref)
        cost_ref = torch.as_tensor(c0.copy())
        add_net_cost(NetRowParams(net, CUTOFF, "cpu"), torch.as_tensor(qc),
                     cost_ref)
        for got, r in ((g, ref[0]), (H, ref[1]), (c, ref[2]), (c2, cost_ref)):
            r = r.numpy()
            np.testing.assert_allclose(got, r, rtol=0,
                                       atol=2e-6 * np.abs(r).max())
        r_row = net_rows(net, torch.as_tensor(qc), CUTOFF)[0].numpy()
        off = r_row == 0
        assert np.array_equal(g[:, off], g0[:, off])
        assert np.array_equal(H[..., off], H0[..., off])
        assert np.array_equal(c[off], c0[off])
        if kind == "bundled":
            assert off.all()
            continue
        assert 0.25 <= 1 - off.mean() <= 0.75
        jnet = jax_net(arrays)
        sd_jax, vjp = jax.vjp(jnet.signed_distance, jnp.asarray(q))
        g_sd = np.asarray(vjp(jnp.ones(100))[0])
        r_jax = np.asarray(jax.nn.relu(CUTOFF - sd_jax))
        r_p, J_p = net_rows(net, torch.as_tensor(qc), CUTOFF)
        np.testing.assert_allclose(r_p.numpy(), r_jax, rtol=1e-5, atol=1e-6)
        J_jax = -(r_jax > 0).astype(F32)[None] * g_sd.T
        np.testing.assert_allclose(J_p.numpy(), J_jax, rtol=1e-5,
                                   atol=1e-6 * np.abs(J_jax).max())


def _net_task():
    return PlanningTask(env=EnvSpheres3D(device="cpu"),
                        robot=RobotPanda.create(
                            use_learned_self_collision=True, device="cpu"),
                        obstacle_cutoff_margin=0.03)


def test_net_task_packs_no_pair_rows():
    """The net robot's K1 and K8 packings have K = 0 pair rows and no
    self-collision points; the cost kernel's model on them plus the net
    row's (tensor-core route) model is the plain cost."""
    task = _net_task()
    lay = TermsLayout(task)
    assert lay.pair_a == [] and lay.pair_b == []
    assert lay.self_margins.numel() == 0
    assert lay.used_links == sorted(task.robot.object_coll_idxs)
    assert len(task.robot.self_pair_idxs) > 0     # the table is still built
    ints, floats = pack_terms_params(lay)
    D, P, NO, K = (int(v) for v in ints[1:5])
    NGRID, G = int(ints[11]), int(ints[12])
    assert (D, P, NO, K, NGRID, G) == (7, 5, 5, 0, 0, 0)
    assert ints.dtype == np.int32 and floats.dtype == np.float32
    c_ints, c_floats = pack_cost_params(lay)
    # the cost kernel's buffers, then the 5 points' joint masks
    np.testing.assert_array_equal(ints[:-P], c_ints)
    np.testing.assert_array_equal(floats, c_floats)
    anc = lay.model.ancestry_matrix()[lay.point_links]
    np.testing.assert_array_equal(ints[-P:], (anc * 1 << np.arange(D))
                                  .sum(1))
    # one group of spheres: its count, its offset, the object's grid (-1)
    assert int(c_ints[-1]) == -1
    assert int(c_ints[4]) == 0 and c_ints.dtype == np.int32
    assert c_floats.dtype == np.float32
    cfg = cost_launch_config(c_ints, len(c_floats))
    assert cfg["threads_per_lane"] == 1 and cfg["smem_bytes"] <= SMEM_MAX
    q = np.ascontiguousarray(box_q(256, seed=8).T)
    got = model_cost(c_ints, c_floats, q)
    net_ints, net_floats = pack_net_params(task.robot.self_collision_net,
                                           task._NET_SELF_CUTOFF)
    model_net_row_tc(net_ints, net_floats, q, None, None, got, terms=False)
    plain = task.collision_residuals.collision_cost_lanes(
        torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-5,
                               atol=3e-5 * np.abs(plain).max())


def test_wrappers_route_by_device_and_check_shapes():
    task = _net_task()
    terms = task.collision_residuals.obstacle_terms_lanes
    row = terms.net_row
    assert row is not None and row.cutoff == task._NET_SELF_CUTOFF
    q = torch.as_tensor(np.ascontiguousarray(box_q(16, seed=9).T))
    with pytest.raises(ValueError):
        add_net_cost(row, q, torch.zeros(15))
    with pytest.raises(ValueError):
        add_net_terms(row, q[:6], torch.zeros(6, 16), torch.zeros(6, 6, 16),
                      torch.zeros(16))
    meta = torch.zeros((7, 16), device="meta")
    with pytest.raises(ValueError):
        add_net_cost(row, meta, torch.zeros(16, device="meta"))
    # a CPU tensor: the plain terms (the net row among their rows)
    g, Hqq, cost = terms.unscaled(q)
    g2, H2, c2 = terms.plain.unscaled(q)
    assert torch.equal(g, g2) and torch.equal(Hqq, H2)
    assert torch.equal(cost, c2)


def test_one_layout_and_one_net_row_per_task():
    """The terms hook's plain terms, kernel packing and net row share one
    TermsLayout, whose cutoff is the task's; the cost hook built without
    the terms hook equals the task's; the net's row needs q_cols."""
    from torch_robotics_tpu_torch.ops.lanes_fk import (fk_lanes, hinge_rows,
                                                       point_jacobians_lanes)
    from torch_robotics_tpu_torch.ops.terms_kernel import \
        collision_cost_kernel_factory
    task = _net_task()
    terms = task.collision_residuals.obstacle_terms_lanes
    lay = terms.plain.layout
    assert terms.net_row.net is lay.net is task.self_collision_net
    assert terms.net_row.cutoff == lay.net_cutoff == task._NET_SELF_CUTOFF
    q = torch.as_tensor(np.ascontiguousarray(box_q(64, seed=10).T))
    alone = collision_cost_kernel_factory(task)
    assert torch.equal(alone(q),
                       task.collision_residuals.collision_cost_lanes(q))
    R_w, t_w = fk_lanes(lay.model, q)
    pts = torch.stack([t_w[li] for li in lay.used_links])
    J = point_jacobians_lanes(lay.model, R_w, t_w, pts, lay.used_links,
                              q_cols=q)
    r, Jr = hinge_rows(lay, pts, J, q)
    r2, Jr2 = terms.plain.rows(q)
    assert torch.equal(r, r2) and torch.equal(Jr, Jr2)
    with pytest.raises(ValueError, match="q_cols"):
        hinge_rows(lay, pts, J)


def test_multirobot_member_with_a_net_raises():
    """The CUDA MultiRobot terms kernel has no net row: a MultiRobot with a
    net member constructs on the CPU with its plain terms and cost (the
    reference's fused factories return None for it), and a tensor off the
    CPU (a meta tensor standing in for a CUDA one) raises at both hooks,
    before any launch: nothing falls back to the plain terms there."""
    from torch_robotics_tpu_torch.core import z_rot
    robot = MultiRobot.create(
        [RobotPanda.create(use_learned_self_collision=True, device="cpu"),
         RobotPanda.create(device="cpu")],
        [(z_rot(torch.tensor(0.0)), torch.tensor([0.0, 0.6, 0.0])),
         (z_rot(torch.tensor(np.pi, dtype=torch.float32)),
          torch.tensor([0.0, -0.6, 0.0]))])
    task = PlanningTask(env=EnvSpheres3D(device="cpu"), robot=robot,
                        obstacle_cutoff_margin=0.03)
    res = task.collision_residuals
    terms, cost = res.obstacle_terms_lanes, res.collision_cost_lanes
    assert "self-collision" in terms.refusal == cost.refusal
    q = torch.zeros((robot.q_dim, 4))
    for a, b in zip(terms.unscaled(q), terms.plain.unscaled(q)):
        assert torch.equal(a, b)
    assert torch.equal(cost(q), cost.plain(q))
    meta = torch.zeros((robot.q_dim, 4), device="meta")
    for hook in (terms.unscaled, lambda x: terms(x, 1.0), cost):
        with pytest.raises(NotImplementedError, match="self-collision"):
            hook(meta)
