"""The learned self-collision row of the GN obstacle terms and of the
value-only collision cost: wrappers, parameter packing, launch shape, and
the plain version.

Counterpart of the net row that torch_robotics_tpu/ops/pallas_terms.py
evaluates inside its fused kernels (``_scalarize_net`` and
``_net_signed_distance`` in the tile bodies of
``obstacle_terms_pallas_factory`` and ``collision_cost_pallas_factory``).
Its CUDA source is ``csrc/net_row.cu``, whose head comment says what
bounds it on the H100 and how its design answers that.  The kernels run
after the terms kernel (``csrc/terms.cu``) or the cost kernel
(``csrc/cost.cu``) and add the row into their unscaled outputs, in place.

The plain version is ``net_rows``: the module's own matmul chain
(``SelfCollisionNet.signed_distance_and_grad``), r = relu(cutoff - sd),
Jr = -[r > 0] d sd/dq, added by ``net_terms_plain`` / ``net_cost_plain``.
``add_net_terms`` and ``add_net_cost`` take it for a CPU tensor; for a
CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import CudaKernel

__all__ = ["NET_TERMS_KERNEL", "NET_COST_KERNEL", "NetRowParams",
           "net_rows", "net_terms_plain", "net_cost_plain",
           "pack_net_params", "net_launch_config", "add_net_terms",
           "add_net_cost"]

_P = ctypes.c_void_p
_I = ctypes.c_int
NET_TERMS_KERNEL = CudaKernel("net_row.cu", {
    "trt_net_terms_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I,
                             _P]})
NET_COST_KERNEL = CudaKernel("net_row.cu", {
    "trt_net_cost_launch": [_P, _P, _I, _I, _I, _I, _P, _P, _I, _P]})
_SMEM_MAX = 232448        # shared memory a block can have on the H100
_ACTIVATIONS = {"relu": 0, "tanh": 1}
_ROUTES = {"simt": 0, "tf32x3": 1}
# simt route: net_row.cu kThreads; lanes a block at most and at least (a
# thread's tile is 4 lanes wide)
_THREADS, _LANES, _MIN_LANES = 256, 32, 4
# tf32x3 route (net_row.cu kTcThreads, kTcIn, TcScratch): the hidden
# widths its kernels are instantiated for, the input width it pads to,
# lanes a warp's tile (terms, cost), a warp's scratch floats (terms)
_TC_HIDDEN = (256, 128, 64)
_TC_THREADS, _TC_IN, _TC_LANES, _TC_COST_LANES = 256, 8, 16, 32
_TC_SCRATCH = 16 * (_TC_IN + 1) + 16 * _TC_IN + _TC_IN + sum(_TC_HIDDEN)


def _pad4(n: int) -> int:
    return -(-int(n) // 4) * 4


def _tc_stride(n_in: int) -> int:
    """Row stride (floats) of a (out, in) weight in the tf32x3 packing: the
    least >= n_in that is 8 mod 16 (net_row.cu TcStride)."""
    return n_in + (8 - n_in) % 16


def net_rows(net, q_cols: torch.Tensor, cutoff: float):
    """Plain net row of q_cols (d, N) -> (r (N,), Jr (d, N)):
    r = relu(cutoff - sd(q)), Jr = -[r > 0] d sd/dq."""
    sd, grad = net.signed_distance_and_grad(q_cols.T)
    r = torch.relu(cutoff - sd)
    act = (r > 0).to(q_cols.dtype)
    return r, (-act[:, None] * grad).T


def net_terms_plain(net, q_cols, cutoff: float, g, Hqq, cost) -> None:
    """The plain version of ``trt_net_terms_launch``: add the row's 0.5 r^2
    to cost (N,), r Jr to g (d, N) and Jr Jr^T to Hqq (d, d, N), in
    place, as tensor ops on q_cols' device."""
    r, Jr = net_rows(net, q_cols, cutoff)
    g += r * Jr
    Hqq += Jr[:, None] * Jr[None, :]
    cost += 0.5 * (r * r)


def net_cost_plain(net, q_cols, cutoff: float, cost) -> None:
    """The plain version of ``trt_net_cost_launch``: add 0.5 r^2 to cost."""
    r = torch.relu(cutoff - net.signed_distance(q_cols.T))
    cost += 0.5 * (r * r)


def _pack_simt(net, cutoff: float):
    """The simt route's buffers: ints [L, activation, d, 0, padded
    widths...]; floats [scale, shift, cutoff, 0, mean, std, then each
    layer's W (padded rows, padded columns) and b], every width padded to a
    multiple of 4 (zero weights and biases, std 1)."""
    a = net.arrays()
    widths = net.widths
    wp = [_pad4(w) for w in widths]
    L = len(widths) - 1
    ints = np.asarray([L, _ACTIVATIONS[net.activation], widths[0],
                       _ROUTES["simt"]] + wp, np.int32)
    sections = [np.asarray([a["scale_out"][0], a["scale_out"][1], cutoff, 0],
                           np.float32),
                _padded(a["mean_q"], wp[0]), _padded(a["std_q"], wp[0], 1.0)]
    for i in range(L):
        W = np.zeros((wp[i], wp[i + 1]), np.float32)
        W[:widths[i], :widths[i + 1]] = a["W%d" % i]
        sections += [W.reshape(-1), _padded(a["b%d" % i], wp[i + 1])]
    return ints, np.concatenate(sections).astype(np.float32)


def _pack_tf32x3(net, cutoff: float):
    """The tf32x3 route's buffers: ints [L, activation, d, 1, 8, hidden...,
    1]; floats [scale, shift, cutoff, 0, mean (8), std (8, padding 1), then
    each hidden layer's W^T (out, in) with rows of ``_tc_stride(in)``
    floats (zero padding) and its b, then the last layer's weights (its
    one column), its bias padded to 4, and the 2-norm of each column of
    every hidden layer's W but the first (the terms kernel's repair bound)]:
    the layout of net_row.cu's TcLayout, every section a multiple of 4
    floats."""
    a = net.arrays()
    widths = net.widths
    L = len(widths) - 1
    ints = np.asarray([L, _ACTIVATIONS[net.activation], widths[0],
                       _ROUTES["tf32x3"], _TC_IN] + list(widths[1:]),
                      np.int32)
    sections = [np.asarray([a["scale_out"][0], a["scale_out"][1], cutoff, 0],
                           np.float32),
                _padded(a["mean_q"], _TC_IN),
                _padded(a["std_q"], _TC_IN, 1.0)]
    n_in = _TC_IN
    for i in range(L - 1):
        W = a["W%d" % i]
        Wt = np.zeros((W.shape[1], _tc_stride(n_in)), np.float32)
        Wt[:, :W.shape[0]] = W.T
        sections += [Wt.reshape(-1), np.asarray(a["b%d" % i], np.float32)]
        n_in = W.shape[1]
    sections += [np.asarray(a["W%d" % (L - 1)][:, 0], np.float32),
                 _padded(a["b%d" % (L - 1)], 4)]
    sections += [np.linalg.norm(np.asarray(a["W%d" % i], np.float64), axis=0)
                 for i in range(1, L - 1)]
    return ints, np.concatenate(sections).astype(np.float32)


def _padded(v, n, fill=0.0):
    out = np.full(n, fill, np.float32)
    out[:len(v)] = v
    return out


def pack_net_params(net, cutoff: float):
    """A ``SelfCollisionNet`` and its hinge cutoff -> (ints int32, floats
    float32), the two buffers ``net_row.cu`` reads, laid out for the route
    that ``net_launch_config`` picks from the net's widths.  Both
    start ints with [L, activation, d, route] and floats with [scale,
    shift, cutoff, 0, mean, std].  simt: every width padded to a multiple
    of 4, each layer's W as (in, out) row-major, then b.  tf32x3: the input
    padded to 8, each hidden layer's W transposed to (out, in), the
    reference's layout and the tensor-core product's K-major operand, with
    rows padded to a stride that is 8 mod 16 (``_tc_stride``), then b; the
    last layer's one column and its bias (padded to 4)."""
    if _route(net.widths) == "tf32x3":
        return _pack_tf32x3(net, cutoff)
    return _pack_simt(net, cutoff)


def _route(widths) -> str:
    """tf32x3 for n_joints <= 8 and the hidden widths its kernel is
    instantiated for, else simt."""
    widths = tuple(int(w) for w in widths)
    return ("tf32x3" if widths[0] <= _TC_IN and widths[1:-1] == _TC_HIDDEN
            and widths[-1] == 1 else "simt")


def _tc_floats(widths) -> int:
    """Length of the tf32x3 float buffer for ``widths``."""
    n, n_in = 4 + 2 * _TC_IN, _TC_IN
    for w in widths[1:-1]:
        n += w * _tc_stride(n_in) + w
        n_in = w
    return n + n_in + 4 + sum(widths[2:-1])


def _simt_launch(widths) -> dict:
    """The simt route's launch shape: 256 threads, the lanes a block (32,
    halved down to 4 while the block's shared memory passes 232,448 bytes),
    the dynamic shared bytes (every layer's activations but the output's,
    and r, per lane); NotImplementedError where 4 lanes do not fit."""
    rows = sum(_pad4(w) for w in widths[:-1]) + 1
    lanes = _LANES
    while lanes > _MIN_LANES and 4 * lanes * rows > _SMEM_MAX:
        lanes //= 2
    smem = 4 * lanes * rows
    if smem > _SMEM_MAX:
        raise NotImplementedError(
            "the CUDA net row's block needs %d bytes of shared memory for "
            "widths %s (at most %d)" % (smem, widths, _SMEM_MAX))
    return dict(route="simt", lanes=lanes, threads=_THREADS,
                smem_bytes=smem, cost_lanes=lanes, cost_smem_bytes=smem)


def net_launch_config(widths, activation: str = "relu") -> dict:
    """Route and launch shape of ``net_row.cu`` for a net of ``widths``
    (n_joints, hidden..., 1) and ``activation``, from those alone.

    - ``tf32x3`` (tensor cores, 3xTF32) for n_joints <= 8 and hidden widths
      (256, 128, 64), the bundled net's: one persistent block of 256
      threads a multiprocessor; a warp's tile is 16 lanes for the terms
      kernel (``lanes``) and 32 for the cost kernel (``cost_lanes``); the
      dynamic shared memory holds the packed net, and for the terms kernel
      each warp's scratch (``_TC_SCRATCH`` floats);
    - ``simt`` (FP32 CUDA cores) for any other net with a hidden layer
      whose block fits: 256 threads, lanes a block and shared memory as
      ``_simt_launch`` gives them, the same for both kernels.

    NotImplementedError for an activation other than relu or tanh, for a
    net without a hidden layer or a single output, and where the simt
    route's 4 lanes pass 232,448 bytes."""
    widths = [int(w) for w in widths]
    if activation not in _ACTIVATIONS:
        raise NotImplementedError("the CUDA net row takes relu or tanh, not "
                                  "%r" % (activation,))
    if len(widths) < 3 or widths[-1] != 1:
        raise NotImplementedError("the CUDA net row takes a net with a "
                                  "hidden layer and one output, got widths "
                                  "%s" % widths)
    if _route(widths) == "tf32x3":
        n_floats = _tc_floats(widths)
        return dict(route="tf32x3", lanes=_TC_LANES, threads=_TC_THREADS,
                    smem_bytes=4 * (n_floats
                                    + _TC_THREADS // 32 * _TC_SCRATCH),
                    cost_lanes=_TC_COST_LANES, cost_smem_bytes=4 * n_floats)
    return _simt_launch(widths)


class NetRowParams:
    """A task's net row: the net, its hinge cutoff, and its packed buffers
    on ``device``; the launch shape is computed at the first launch."""

    def __init__(self, net, cutoff: float, device):
        self.net = net
        self.cutoff = float(cutoff)
        ints, floats = pack_net_params(net, self.cutoff)
        self.ints = torch.as_tensor(ints, device=device)
        self.floats = torch.as_tensor(floats, device=device)
        self._launch = None

    @property
    def launch(self) -> dict:
        if self._launch is None:
            self._launch = net_launch_config(self.net.widths,
                                             self.net.activation)
        return self._launch


def _check(row: NetRowParams, q_cols, outputs):
    d = row.net.widths[0]
    if q_cols.dim() != 2 or q_cols.shape[0] != d:
        raise ValueError("q_cols must be (%d, N), got %s"
                         % (d, tuple(q_cols.shape)))
    N = q_cols.shape[1]
    for t, shape in zip(outputs, ((d, N), (d, d, N), (N,))[-len(outputs):]):
        if tuple(t.shape) != shape:
            raise ValueError("output of shape %s, expected %s"
                             % (tuple(t.shape), shape))
    if q_cols.device.type == "cpu":
        return
    if q_cols.device.type != "cuda":
        raise ValueError("the net row takes CPU or CUDA tensors")
    for t in (q_cols, *outputs):
        if t.device != q_cols.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("the net row kernels take contiguous float32 "
                             "tensors on one CUDA device")
    if row.ints.device != q_cols.device:
        raise ValueError("the net's kernel parameters live on %s, q_cols on "
                         "%s" % (row.ints.device, q_cols.device))


def add_net_terms(row: NetRowParams, q_cols: torch.Tensor, g: torch.Tensor,
                  Hqq: torch.Tensor, cost: torch.Tensor) -> None:
    """Add the net row's contribution to unscaled terms in place: 0.5 r^2
    to cost (N,), r Jr to g (d, N), Jr Jr^T to Hqq (d, d, N).  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    _check(row, q_cols, (g, Hqq, cost))
    if q_cols.device.type == "cpu":
        net_terms_plain(row.net, q_cols, row.cutoff, g, Hqq, cost)
        return
    N = q_cols.shape[1]
    if N == 0:
        return
    launch = row.launch
    with torch.cuda.device(q_cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        NET_TERMS_KERNEL.launch(
            "trt_net_terms_launch", q_cols.data_ptr(), g.data_ptr(),
            Hqq.data_ptr(), cost.data_ptr(), N, _ROUTES[launch["route"]],
            launch["lanes"], launch["smem_bytes"], row.ints.data_ptr(),
            row.floats.data_ptr(), row.floats.numel(), stream)


def add_net_cost(row: NetRowParams, q_cols: torch.Tensor,
                 cost: torch.Tensor) -> None:
    """Add the net row's 0.5 r^2 to cost (N,) in place (plain version for a
    CPU tensor, the kernel for a CUDA tensor)."""
    _check(row, q_cols, (cost,))
    if q_cols.device.type == "cpu":
        net_cost_plain(row.net, q_cols, row.cutoff, cost)
        return
    N = q_cols.shape[1]
    if N == 0:
        return
    launch = row.launch
    with torch.cuda.device(q_cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        NET_COST_KERNEL.launch(
            "trt_net_cost_launch", q_cols.data_ptr(), cost.data_ptr(), N,
            _ROUTES[launch["route"]], launch["cost_lanes"],
            launch["cost_smem_bytes"], row.ints.data_ptr(),
            row.floats.data_ptr(), row.floats.numel(), stream)
