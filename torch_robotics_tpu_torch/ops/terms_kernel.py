"""Fused GN obstacle-terms kernel and value-only collision-cost kernel:
wrappers, parameter packing, dispatch.

Counterparts of torch_robotics_tpu/ops/pallas_terms.py
(``obstacle_terms_pallas_factory`` and ``collision_cost_pallas_factory``,
the TPU kernels they replace).  The CUDA source of both is
``csrc/terms.cu``; its head comment says what bounds each on the H100 and
how its design answers that.  The plain PyTorch version of both is
``ops/lanes_fk.obstacle_terms_lanes_factory`` (the cost kernel's is the
cost output of its unscaled terms).

The returned ``terms(q_cols, lam, h=None)`` keeps the reference contract:
the kernel writes the unscaled g (d, N), Hqq (d, d, N) and cost (N); the
wrapper applies lam and embeds them into g (H, m, B), Hb (H, m, m, B),
cost (H, B) (or the h=None lanes layout).  A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.

``collision_cost_kernel_factory(task)`` returns ``cost(q_cols (d, N)) ->
(N,)``, 0.5 sum r^2 over the same rows, unscaled, with the same dispatch.
It is not differentiable: solvers that need gradients use the terms.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import CudaKernel
from .lanes_fk import TermsLayout, embed_terms, obstacle_terms_lanes_factory

__all__ = ["KERNEL", "COST_KERNEL", "MAX_DOF",
           "obstacle_terms_kernel_factory", "collision_cost_kernel_factory",
           "pack_terms_params", "run_terms_kernel", "run_cost_kernel"]

_P = ctypes.c_void_p
KERNEL = CudaKernel("terms.cu", {
    "trt_terms_launch": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P,
                         _P],
})
COST_KERNEL = CudaKernel("terms.cu", {
    "trt_cost_launch": [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P],
})
MAX_DOF = 8        # terms.cu instantiates D = 1..8
_MAX_LINKS = 32    # terms.cu kMaxLinks
_GROUP_KIND = {"Spheres": 0, "RoundedBoxes": 1, "SharpBoxes": 2}


def pack_terms_params(lay: TermsLayout):
    """Model + scene + collision rows -> (ints int32, floats float32), the
    two buffers ``terms.cu`` reads (section order as in its parse_layout)."""
    from ..geom.sdf import ObjectField
    model = lay.model
    L = model.n_links
    ctrl = list(model.controlled_link_idxs())
    D = len(ctrl)
    anc = model.ancestry_matrix()
    q_idx = np.full(L, -1, np.int64)
    q_idx[ctrl] = np.arange(D)

    group_kind, group_count, group_off, obj_begin = [], [], [], [0]
    obj_rot, obj_pos, prims = [], [], []
    n_prims = 0
    for obj in lay.df_obj_list:
        if not isinstance(obj, ObjectField):
            raise NotImplementedError(
                "grid-SDF extras are not in the CUDA terms kernel yet")
        if obj.dim != 3:
            raise NotImplementedError("the CUDA terms kernel takes 3-D scenes")
        obj_rot.append(obj.rotation_matrix().cpu().numpy().reshape(9))
        obj_pos.append(obj.pos.cpu().numpy())
        for f in obj.fields:
            kind = type(f).__name__
            cols = [f.centers, f.radii[:, None]] if kind == "Spheres" else (
                [f.centers, f.half_sizes, f.round_radii[:, None]]
                if kind == "RoundedBoxes" else [f.centers, f.half_sizes])
            table = torch.cat(cols, dim=1).cpu().numpy()
            group_kind.append(_GROUP_KIND[kind])
            group_count.append(table.shape[0])
            group_off.append(n_prims)
            prims.append(table.reshape(-1))
            n_prims += table.size
        obj_begin.append(len(group_kind))

    header = [L, D, len(lay.used_links), len(lay.obj_pos), len(lay.pair_a),
              len(lay.df_obj_list), len(group_kind), 0]
    anc_bits = [int(sum(1 << j for j in range(D) if anc[li, j]))
                for li in lay.used_links]
    ints = np.concatenate([np.asarray(s, np.int64).reshape(-1) for s in (
        header, model.topological_order(), model.parent_idx,
        model.joint_types, q_idx, ctrl, lay.used_links, anc_bits,
        lay.obj_pos, lay.pair_a, lay.pair_b, obj_begin, group_kind,
        group_count, group_off)]).astype(np.int32)

    def f32(x):
        return np.asarray(x, np.float32).reshape(-1)

    floats = np.concatenate([f32(s) for s in (
        model.joint_trans, model.joint_fixed_rot, model.joint_axis,
        model.clamp_lower, model.clamp_upper,
        lay.obj_thresh.cpu().numpy(), lay.self_margins.cpu().numpy(),
        lay.ws_min.cpu().numpy(), lay.ws_max.cpu().numpy(),
        np.zeros(0) if not obj_rot else np.stack(obj_rot),
        np.zeros(0) if not obj_pos else np.stack(obj_pos),
        np.zeros(0) if not prims else np.concatenate(prims))])
    return ints, floats


def _check_q(q_cols, ints, floats, d: int):
    if q_cols.device.type != "cuda":
        raise ValueError("the terms.cu kernels take CUDA tensors")
    if q_cols.dtype != torch.float32 or not q_cols.is_contiguous():
        raise ValueError("q_cols must be contiguous float32")
    if q_cols.dim() != 2 or q_cols.shape[0] != d:
        raise ValueError("q_cols must be (%d, N), got %s"
                         % (d, tuple(q_cols.shape)))
    if ints.device != q_cols.device or floats.device != q_cols.device:
        raise ValueError("the task's kernel parameters live on %s, q_cols "
                         "on %s" % (ints.device, q_cols.device))


def run_terms_kernel(q_cols: torch.Tensor, ints: torch.Tensor,
                     floats: torch.Tensor, d: int):
    """Launch the CUDA terms kernel: q_cols (d, N) float32 contiguous CUDA
    -> unscaled (g_q (d, N), Hqq (d, d, N), cost (N,))."""
    _check_q(q_cols, ints, floats, d)
    N = q_cols.shape[1]
    g = torch.empty((d, N), dtype=torch.float32, device=q_cols.device)
    Hqq = torch.empty((d, d, N), dtype=torch.float32, device=q_cols.device)
    cost = torch.empty((N,), dtype=torch.float32, device=q_cols.device)
    if N == 0:
        return g, Hqq, cost
    with torch.cuda.device(q_cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch("trt_terms_launch", q_cols.data_ptr(), g.data_ptr(),
                      Hqq.data_ptr(), cost.data_ptr(), N, d, ints.data_ptr(),
                      floats.data_ptr(), stream)
    return g, Hqq, cost


def run_cost_kernel(q_cols: torch.Tensor, ints: torch.Tensor,
                    floats: torch.Tensor, d: int):
    """Launch the CUDA value-only cost kernel: q_cols (d, N) float32
    contiguous CUDA -> unscaled cost (N,)."""
    _check_q(q_cols, ints, floats, d)
    N = q_cols.shape[1]
    cost = torch.empty((N,), dtype=torch.float32, device=q_cols.device)
    if N == 0:
        return cost
    with torch.cuda.device(q_cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        COST_KERNEL.launch("trt_cost_launch", q_cols.data_ptr(),
                           cost.data_ptr(), N, d, ints.data_ptr(),
                           floats.data_ptr(), stream)
    return cost


def _kernel_params(task):
    """(d, ints, floats, plain terms) of a task the terms.cu kernels take,
    or None where the reference's fused factories return None (robots
    without a kinematic model, interpolated collision points).  The learned
    self-collision row, grid-SDF scenes and grasped-object points are not
    in the kernels yet and raise NotImplementedError."""
    robot = task.robot
    if not hasattr(robot, "model") or robot.object_interpolate:
        return None
    if getattr(robot, "self_collision_net", None) is not None:
        raise NotImplementedError(
            "the learned self-collision row is not in the CUDA terms kernel")
    if getattr(robot, "grasped_n_points", 0) > 0:
        raise NotImplementedError(
            "grasped-object points are not in the CUDA terms kernel")
    lay = TermsLayout(task)
    d = lay.model.n_dofs
    if d > MAX_DOF or lay.model.n_links > _MAX_LINKS:
        raise NotImplementedError(
            "the CUDA terms kernel takes at most %d joints and %d links"
            % (MAX_DOF, _MAX_LINKS))
    ints_np, floats_np = pack_terms_params(lay)
    ints = torch.as_tensor(ints_np, device=task.device)
    floats = torch.as_tensor(floats_np, device=task.device)
    return d, ints, floats, obstacle_terms_lanes_factory(task)


def obstacle_terms_kernel_factory(task):
    """GN obstacle terms of a single-kinematic-model robot in an analytic
    primitive scene, through the CUDA terms kernel for CUDA tensors (None
    and NotImplementedError as ``_kernel_params``)."""
    params = _kernel_params(task)
    if params is None:
        return None
    d, ints, floats, plain = params

    def terms(q_cols, lam, h=None):
        if q_cols.device.type == "cpu":
            return plain(q_cols, lam, h=h)
        return embed_terms(*run_terms_kernel(q_cols, ints, floats, d), lam,
                           h=h)

    def unscaled(q_cols):
        if q_cols.device.type == "cpu":
            return plain.unscaled(q_cols)
        return run_terms_kernel(q_cols, ints, floats, d)

    terms.unscaled = unscaled
    terms.plain = plain
    return terms


def collision_cost_kernel_factory(task):
    """Per-waypoint collision cost 0.5 sum r^2 (unscaled) of the same tasks,
    through the CUDA cost kernel for CUDA tensors; the plain version is the
    cost output of the plain terms."""
    params = _kernel_params(task)
    if params is None:
        return None
    d, ints, floats, plain_terms = params

    def plain(q_cols):
        return plain_terms.unscaled(q_cols)[2]

    def cost(q_cols):
        if q_cols.device.type == "cpu":
            return plain(q_cols)
        return run_cost_kernel(q_cols, ints, floats, d)

    cost.plain = plain
    return cost
