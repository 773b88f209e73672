"""Block-tridiagonal sweep kernels: wrappers and dispatch.

Counterparts of torch_robotics_tpu/ops/pallas_btridiag.py:

- ``solve_lanes_w``: the W-persisting sweep (``solve_lanes_pallas_w``)
  that the reference routes m <= 16 to; CUDA source ``csrc/btridiag.cu``.
- ``solve_lanes_cols``: the column sweep for large m
  (``solve_lanes_pallas_cols`` with its trsv backward tail); CUDA source
  ``csrc/btridiag_cols.cu``, m <= 64 in padded widths 24, 32, 40, 48, 64,
  launched as ``cols_launch_config`` says.
- ``solve_lanes_cols_wide``: the same solve for 64 < m <= 128, past what
  the column sweep's registers hold; CUDA source
  ``csrc/btridiag_cols_wide.cu`` (a block of 256 threads a lane, 512
  where an SM holds one lane, the bordered matrix in shared memory,
  panels of 16 factored inside a warp, the trailing update on the FP64
  tensor cores), padded widths 80, 96, 112, 128, launched as
  ``cols_launch_config`` says.
- ``solve_lanes_auto``: the reference's routing (``solve_lanes_auto`` and
  the m > 32 branch of ``gpmp2._gpmp2_step_lanes_impl``): m <= 16 to the
  W-persisting sweep, larger m to the column sweep (its shared-memory
  route past m = 64); past m = 128 it raises.
- ``solve_lanes_factor``: the W-persisting sweep with its factors L and W
  as outputs (``solve_lanes_pallas_factor``), and ``solve_lanes_subst``:
  the substitution-only re-solve from them with a fresh right-hand side
  (``solve_lanes_pallas_subst``), a group of threads per lane as the sweep
  has, launched as ``subst_launch_config`` says; GN factorization reuse.
  Both in ``csrc/btridiag.cu``, m in {2, 4, ..., 16}.
- ``solve_lanes_sweep(D, U, b, bwd_trsv=False)``: the sweep that keeps L
  and y only and recomputes W_k in its backward pass, by a triangular solve
  or, with ``bwd_trsv``, as a matvec and a triangular vector solve
  (``solve_lanes_pallas``); the W-persisting sweep's kernel in its L-and-y
  modes (``csrc/btridiag.cu``, the same forward pass and launch shape,
  ``sweep_launch_config``), m in {2, 4, ..., 16}.  Nothing routes to it
  (the reference reaches it only when its chip's memory budget refuses the
  W-persisting sweep).
- ``solve_lanes_cr``: block cyclic reduction (``solve_lanes_pallas_bcr``),
  H padded to a power of two with identity blocks; CUDA source
  ``csrc/btridiag_cr.cu`` (one launch: a block a tile of lanes through
  every level), launched as ``cr_launch_config`` says, m in {2, 4, ...,
  16}.  Its plain version is ``solve/btridiag_bcr.solve_lanes_bcr``.
  Nothing routes to it.

Each CUDA source's head comment says what bounds its kernel on the H100
and how its design answers that.  The plain PyTorch version of the sweeps
is ``solve/btridiag_lanes.solve_lanes_core``, generic in m (with
``solve_lanes_factor_core`` and ``solve_lanes_subst_core`` for the reuse
pair).

The sweeps take D (H, m, m, B), U (H, m, m, 1) shared over the batch (last
block unused) and b (H, m, B) and return x (H, m, B).  A CPU tensor takes
the plain version; a CUDA tensor launches a kernel or raises.  A per-batch
U raises, as the reference kernels refuse it.
"""
from __future__ import annotations

import ctypes

import torch

from ..solve.btridiag_bcr import solve_lanes_bcr
from ..solve.btridiag_lanes import (solve_lanes_core, solve_lanes_factor_core,
                                    solve_lanes_subst_core)
from .cuda_build import CudaKernel

__all__ = ["KERNEL", "COLS_KERNEL", "COLS_WIDE_KERNEL", "FACTOR_KERNEL", "SUBST_KERNEL",
           "SWEEP_KERNEL", "CR_KERNEL", "solve_lanes_w", "solve_lanes_cols",
           "solve_lanes_cols_wide", "solve_lanes_auto",
           "solve_lanes_factor", "solve_lanes_subst",
           "solve_lanes_sweep", "solve_lanes_cr", "sweep_launch_config",
           "subst_launch_config", "cols_launch_config", "cr_launch_config"]

_P = ctypes.c_void_p
KERNEL = CudaKernel("btridiag.cu", {
    "trt_btridiag_w_launch": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
})
COLS_KERNEL = CudaKernel("btridiag_cols.cu", {
    "trt_btridiag_cols_launch": [_P, _P, _P, _P, _P, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 _P],
})
COLS_WIDE_KERNEL = CudaKernel("btridiag_cols_wide.cu", {
    "trt_btridiag_cols_wide_launch": [_P] * 5 + [ctypes.c_int] * 4 + [_P],
})
FACTOR_KERNEL = CudaKernel("btridiag.cu", {
    "trt_btridiag_factor_launch": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   _P],
})
SUBST_KERNEL = CudaKernel("btridiag.cu", {
    "trt_btridiag_subst_launch": [_P, _P, _P, _P] + [ctypes.c_int] * 5 + [_P],
})
SWEEP_KERNEL = CudaKernel("btridiag.cu", {
    "trt_btridiag_sweep_launch": [_P] * 6 + [ctypes.c_int] * 5 + [_P],
})
CR_KERNEL = CudaKernel("btridiag_cr.cu", {
    "trt_btridiag_cr_launch": [_P] * 10 + [ctypes.c_int] * 6 + [_P],
})
# btridiag.cu and btridiag_cr.cu instantiations
_KERNEL_M = (2, 4, 6, 8, 10, 12, 14, 16)
_COLS_MAX_M = 128                     # btridiag_cols_wide.cu kMaxM
_COLS_REG_MAX_M = 64                        # btridiag_cols.cu kMaxM
_COLS_WIDTHS = (24, 32, 40, 48, 64)         # btridiag_cols.cu instantiations
_COLS_WIDE_WIDTHS = (80, 96, 112, 128)      # btridiag_cols_wide.cu's
_COLS_WIDE_PANEL = 16                       # btridiag_cols_wide.cu kPanel
_N_SM = 132                                 # H100 SXM
_W_MAX_M = 16     # the reference's _SCALAR_KERNEL_MAX_M: above it, columns
_SWEEP_THREADS = 128                        # btridiag.cu kSweepThreads
_SWEEP_STAGES = 5                           # btridiag.cu kStages
_SUBST_STAGES = 8                           # btridiag.cu kSubstStages
_CR_MAX_THREADS = 256                       # btridiag_cr.cu kMaxThreads
_CR_WARPS = 8     # K11's default launch: about this many warps an SM
_SMEM_MAX = 232448        # shared memory a block can have on the H100
_SM_SMEM = 233472         # shared memory of one SM
_BLOCK_SMEM_RESERVED = 1024   # of it reserved by CUDA for each block


def _group(m: int) -> int:
    """Threads a lane (or unit) in the sweeps and cyclic reduction: the
    power of two >= m."""
    group = 2
    while group < m:
        group *= 2
    return group


def sweep_launch_config(m: int, B: int) -> dict:
    """Launch shape of the sweeps of ``btridiag.cu`` (W-persisting, factor,
    L-and-y): a group of ``group`` threads per lane (the power of two >=
    m), ``lanes_per_block`` lanes per block (128 threads; a batch smaller
    than that takes fewer lanes, down to one warp), the dynamic shared
    memory (``sweep_smem_floats`` in the source, in bytes) and the grid.
    NotImplementedError for an m the kernels are not built for."""
    _check_m(m)
    group = _group(m)
    lanes = _SWEEP_THREADS // group
    while lanes * group > 32 and lanes // 2 >= B:
        lanes //= 2
    w_row = -(-m // 4) * 4
    stage = max(m * m * (lanes + 1) + m * lanes + m * m,
                (2 * m * m + m) * lanes)
    floats = lanes * (m * w_row + 4 + m) + _SWEEP_STAGES * stage
    return dict(group=group, lanes_per_block=lanes, threads=lanes * group,
                smem_bytes=4 * floats, grid=-(-B // lanes))


def subst_launch_config(m: int, B: int, H: int, keep_lw=None) -> dict:
    """Launch shape of the substitution (``btridiag_subst_kernel``): the
    sweep's group of ``group`` threads per lane, ``lanes_per_block`` lanes
    a block (whole warps; doubled up to 128 threads while the grid keeps at
    least one block per SM), whether every step's L and W stay in shared
    memory between the passes (``keep_lw``; by default where the whole
    grid is then resident at once: 0.068 against 0.091 ms at (32, 14,
    256) on an H100; at B = 1024 and 4096, where it is not, the ring of
    stages is 1.5-1.8x faster), the dynamic shared memory in bytes
    (``subst_smem_floats`` in the source: each lane's y, and the stages of
    L_k, W_k and b_k, a ring of 8 or one a step) and the grid.
    NotImplementedError where the block passes the H100's 232,448
    bytes."""
    group = _group(m)
    lanes = max(1, 32 // group)
    while (2 * lanes * group <= _SWEEP_THREADS
           and -(-B // (2 * lanes)) >= _N_SM):
        lanes *= 2
    grid = -(-B // lanes)

    def smem(stages):
        return 4 * lanes * (H * m + stages * (2 * m * m + m))
    if keep_lw is None:
        per_sm = _SM_SMEM // (smem(H) + _BLOCK_SMEM_RESERVED)
        keep_lw = smem(H) <= _SMEM_MAX and grid <= _N_SM * per_sm
    nbytes = smem(H if keep_lw else _SUBST_STAGES)
    if nbytes > _SMEM_MAX:
        raise NotImplementedError(
            "the CUDA substitution's block needs %d bytes of shared memory "
            "at H = %d, m = %d (at most %d)" % (nbytes, H, m, _SMEM_MAX))
    return dict(group=group, lanes_per_block=lanes, threads=lanes * group,
                keep_lw=bool(keep_lw), smem_bytes=nbytes, grid=grid)


def cols_launch_config(m: int, B: int) -> dict:
    """Launch shape of the column sweep.  For m <= 64 its register route
    (``route`` "registers", ``btridiag_cols.cu``): the padded width it is
    built for (the least of ``_COLS_WIDTHS`` >= m), a group of ``group``
    threads per lane (the whole warps that cover the 2 w + 1 columns of
    the bordered matrix), ``lanes_per_block`` lane groups a block (as few
    as let the grid reach every SM; at most 2, and 1 where two groups
    would pass 8 warps: ``kMaxLanes``), one named barrier id per group
    (``barrier_ids``; id 0 is the block's own), the dynamic shared memory
    in bytes (``ColsShape::kLaneFloats`` per lane) and the grid.  For 64 <
    m <= 128 its shared-memory route (``route`` "shared",
    ``btridiag_cols_wide.cu``): the padded width (the least of
    ``_COLS_WIDE_WIDTHS`` >= m), one lane a block, the blocks an SM
    (``blocks_per_sm``: as many as the shared memory holds, at most two,
    so that B = 256 runs in one wave at widths 80 and 96) and the threads
    a lane the source fixes by the width (``WideShape::kThreads``: 256
    where two lanes share an SM, 512 where one lane has it alone, widths
    112 and 128); the dynamic shared memory (``WideShape::kBytes``: the
    forward pass's packed bordered triangle at the width, the panel's
    rows below it in double and its diagonal block, or the backward
    pass's buffers, the larger), the scratch floats a lane and step
    (``step_floats``) and the grid.  NotImplementedError past m = 128."""
    if not 1 <= m <= _COLS_MAX_M:
        raise NotImplementedError(
            "the CUDA column sweep takes 1 <= m <= %d, got %d"
            % (_COLS_MAX_M, m))
    if m > _COLS_REG_MAX_M:
        w = next(w for w in _COLS_WIDE_WIDTHS if w >= m)
        nbytes = _cols_wide_smem(w)
        per_sm = min(_SM_SMEM // (nbytes + _BLOCK_SMEM_RESERVED), 2)
        return dict(route="shared", width=w,
                    threads=256 if per_sm > 1 else 512, lanes_per_block=1,
                    blocks_per_sm=per_sm, smem_bytes=nbytes,
                    step_floats=cols_wide_step_floats(m), grid=B)
    w = next(w for w in _COLS_WIDTHS if w >= m)
    n2 = 2 * w + 1
    group = -(-n2 // 32) * 32
    lanes = min(2 if group <= 128 else 1, max(1, -(-B // _N_SM)))
    slot = -(-n2 // 4) * 4
    lane_floats = max(2 * slot + (w + 1) * w + 2 * (2 * w * w + w),
                      2 * (2 * w * (w + 1) + 2 * w))
    return dict(route="registers", width=w, group=group,
                lanes_per_block=lanes, threads=lanes * group,
                barrier_ids=tuple(range(1, lanes + 1)),
                smem_bytes=4 * lane_floats * lanes, grid=-(-B // lanes))


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def cols_wide_step_floats(m: int) -> int:
    """Floats of ``btridiag_cols_wide.cu``'s scratch a lane and step
    (``step_floats``): L_k packed by columns, W_k's m rows at a stride of
    round4(m), y_k."""
    return _round4(m * (m + 1) // 2) + (m + 1) * _round4(m)


def _cols_wide_smem(w: int) -> int:
    """``WideShape<w>::kBytes``: the forward pass's packed triangle of the
    2 w + 1 bordered matrix (rounded to 4 floats), the panel's rows below
    it (double, 16 a row, 2 w + 1 - 16 rows rounded to 8) and the
    diagonal block (16 x 16 double); or the backward pass's two packed
    L_k, W_k and y_k at a stride of round4(w), x and r in double: the
    larger."""
    n2 = 2 * w + 1
    panel = _COLS_WIDE_PANEL
    rows = -(-(n2 - panel) // 8) * 8
    fwd = (_round4(n2 * (n2 + 1) // 2) + 2 * panel * rows
           + 2 * panel * panel)
    bwd = 2 * _round4(w * (w + 1) // 2) + (w + 1) * _round4(w) + 4 * w
    return 4 * max(fwd, bwd)


def cr_launch_config(m: int, B: int, H: int, lanes=None,
                     threads=None) -> dict:
    """Launch shape of block cyclic reduction (``btridiag_cr.cu``): one
    block a tile of ``lanes_per_block`` lanes through every level, its
    ``threads`` threads groups of ``group`` (the power of two >= m), one
    (pair of blocks, lane) unit a group at a time.  By default the most
    lanes (a power of two, at most 8) that leave at least two blocks an
    SM, and the groups a lane (a power of two, at most H2 / 2) that give
    the grid about 8 warps an SM (``_CR_WARPS``), in whole warps, at most
    256 threads: at (64, 14, 1024) 2 lanes of 2 groups took 0.40 ms on
    an H100, 1 group a lane 0.66-0.67 and 4 groups 0.43-0.45; at B = 4096
    one group a lane was the faster (PERF.md, K11's row).  Also the
    dynamic shared memory in bytes (``cr_smem_floats`` in the source:
    four m x m blocks a group, and a ring of groups + lanes slots of m^2
    + m floats), H2 (the padded horizon) and the grid.
    NotImplementedError for an m the kernel is not built for, or a block
    the H100 does not take (threads not a multiple of 32 and of the
    group, past 256, or shared memory past 232,448 bytes)."""
    _check_m(m)
    group = _group(m)
    H2 = 1
    while H2 < H:
        H2 *= 2
    if lanes is None:
        lanes = 1
        while lanes < 8 and -(-B // (2 * lanes)) >= 2 * _N_SM:
            lanes *= 2
    if threads is None:
        per_lane = 1
        while (2 * per_lane <= max(H2 // 2, 1)
               and 2 * per_lane * B * group <= 32 * _CR_WARPS * _N_SM):
            per_lane *= 2
        threads = min(_CR_MAX_THREADS,
                      -(-lanes * per_lane * group // 32) * 32)
    groups = threads // group
    if (threads % 32 or threads % group or not 32 <= threads
            <= _CR_MAX_THREADS or lanes < 1):
        raise NotImplementedError(
            "the CUDA cyclic reduction takes 32 to %d threads a block in "
            "whole warps and groups of %d, and lanes >= 1; got %d threads, "
            "%d lanes" % (_CR_MAX_THREADS, group, threads, lanes))
    nbytes = 4 * (groups * 4 * m * m + (groups + lanes) * (m * m + m))
    if nbytes > _SMEM_MAX:
        raise NotImplementedError(
            "the CUDA cyclic reduction's block needs %d bytes of shared "
            "memory at m = %d, %d threads, %d lanes (at most %d)"
            % (nbytes, m, threads, lanes, _SMEM_MAX))
    return dict(group=group, threads=threads, lanes_per_block=lanes,
                smem_bytes=nbytes, H2=H2, grid=-(-B // lanes))


def _check(D, U, b):
    if D.dim() != 4 or D.shape[1] != D.shape[2]:
        raise ValueError("D must be (H, m, m, B), got %s" % (tuple(D.shape),))
    H, m, _, B = D.shape
    if U.dim() != 4 or tuple(U.shape[:3]) != (H, m, m):
        raise ValueError("U must be (H, m, m, 1), got %s" % (tuple(U.shape),))
    if U.shape[3] != 1:
        raise ValueError("per-batch U (last dim %d) is not supported: the "
                         "off-diagonal blocks must be shared over the batch"
                         % U.shape[3])
    if tuple(b.shape) != (H, m, B):
        raise ValueError("b must be (H, m, B) = %s, got %s"
                         % ((H, m, B), tuple(b.shape)))
    if len({D.device, U.device, b.device}) != 1:
        raise ValueError("D, U and b must be on one device")


def _check_cuda(name, D, U, b, keys=("D", "U", "b")):
    if D.device.type != "cuda":
        raise ValueError("%s takes CPU or CUDA tensors" % name)
    for key, t in zip(keys, (D, U, b)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("%s must be contiguous float32" % key)


def _check_m(m: int) -> None:
    if m not in _KERNEL_M:
        raise NotImplementedError(
            "the CUDA sweep takes m in %s, got %d" % (_KERNEL_M, m))


def solve_lanes_w(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor):
    """Block-tridiagonal SPD solve in the lanes layout, m in 2..16 even on
    the card (see module doc)."""
    _check(D, U, b)
    if D.device.type == "cpu":
        return solve_lanes_core(D, U, b)
    _check_cuda("solve_lanes_w", D, U, b)
    H, m, _, B = D.shape
    _check_m(m)
    x = torch.empty((H, m, B), dtype=torch.float32, device=D.device)
    if B == 0 or H == 0:
        return x
    Ls = torch.empty((H, m, m, B), dtype=torch.float32, device=D.device)
    Ws = torch.empty_like(Ls)
    ys = torch.empty((H, m, B), dtype=torch.float32, device=D.device)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch("trt_btridiag_w_launch", D.data_ptr(), U.data_ptr(),
                      b.data_ptr(), x.data_ptr(), Ls.data_ptr(),
                      Ws.data_ptr(), ys.data_ptr(), H, m, B,
                      sweep_launch_config(m, B)["lanes_per_block"], stream)
    return x


def solve_lanes_cols(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor):
    """Block-tridiagonal SPD solve in the lanes layout through the column
    sweep's register route, m up to 64 on the card (see module doc)."""
    _check(D, U, b)
    if D.device.type == "cpu":
        return solve_lanes_core(D, U, b)
    _check_cuda("solve_lanes_cols", D, U, b)
    H, m, _, B = D.shape
    cfg = cols_launch_config(m, max(B, 1))
    if cfg["route"] != "registers":
        raise NotImplementedError(
            "the CUDA column sweep's register route takes 1 <= m <= %d, "
            "got %d (solve_lanes_cols_wide takes it)" % (_COLS_REG_MAX_M, m))
    return _launch_cols(D, U, b, cfg["lanes_per_block"])


def _launch_cols(D, U, b, lanes: int):
    """The column sweep's launch at ``lanes`` lane groups a block (checked
    CUDA inputs); a lane's result does not depend on ``lanes``."""
    H, m, _, B = D.shape
    x = torch.empty((H, m, B), dtype=torch.float32, device=D.device)
    if B == 0 or H == 0:
        return x
    Ls = torch.empty((B, H, m + 1, m), dtype=torch.float32, device=D.device)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        COLS_KERNEL.launch("trt_btridiag_cols_launch", D.data_ptr(),
                           U.data_ptr(), b.data_ptr(), x.data_ptr(),
                           Ls.data_ptr(), H, m, B, lanes, stream)
    return x


def solve_lanes_cols_wide(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor):
    """Block-tridiagonal SPD solve in the lanes layout through the column
    sweep's shared-memory route, 64 < m <= 128 on the card (see module
    doc)."""
    _check(D, U, b)
    if D.device.type == "cpu":
        return solve_lanes_core(D, U, b)
    _check_cuda("solve_lanes_cols_wide", D, U, b)
    H, m, _, B = D.shape
    cfg = cols_launch_config(m, max(B, 1))
    if cfg["route"] != "shared":
        raise NotImplementedError(
            "the CUDA column sweep's shared-memory route takes %d < m <= "
            "%d, got %d (solve_lanes_cols takes it)"
            % (_COLS_REG_MAX_M, _COLS_MAX_M, m))
    return _launch_cols_wide(D, U, b, cfg["width"])


def _launch_cols_wide(D, U, b, width: int):
    """The shared-memory route's launch in padded width ``width`` (checked
    CUDA inputs, m <= width); a lane's result does not depend on
    ``width``."""
    H, m, _, B = D.shape
    x = torch.empty((H, m, B), dtype=torch.float32, device=D.device)
    if B == 0 or H == 0:
        return x
    Ls = torch.empty((B, H, cols_wide_step_floats(m)), dtype=torch.float32,
                     device=D.device)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        COLS_WIDE_KERNEL.launch("trt_btridiag_cols_wide_launch", D.data_ptr(),
                                U.data_ptr(), b.data_ptr(), x.data_ptr(),
                                Ls.data_ptr(), H, m, B, width, stream)
    return x


def solve_lanes_auto(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor):
    """The reference's routing: m <= 16 to the W-persisting sweep, larger m
    to the column sweep (its register route to m = 64, its shared-memory
    route to m = 128; past that NotImplementedError); a CPU tensor takes
    the plain version for every m (see module doc)."""
    _check(D, U, b)
    if D.device.type == "cpu":
        return solve_lanes_core(D, U, b)
    if D.shape[1] <= _W_MAX_M:
        return solve_lanes_w(D, U, b)
    if D.shape[1] <= _COLS_REG_MAX_M:
        return solve_lanes_cols(D, U, b)
    return solve_lanes_cols_wide(D, U, b)


def solve_lanes_factor(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor):
    """The W-persisting sweep that also returns its factors: D, U, b as
    ``solve_lanes_w`` -> (x (H, m, B), L (H, m, m, B), W (H, m, m, B)),
    L lower with a zero strict upper triangle; m in 2..16 even on the
    card."""
    _check(D, U, b)
    if D.device.type == "cpu":
        return solve_lanes_factor_core(D, U, b)
    _check_cuda("solve_lanes_factor", D, U, b)
    H, m, _, B = D.shape
    _check_m(m)
    kw = dict(dtype=torch.float32, device=D.device)
    x = torch.empty((H, m, B), **kw)
    Ls = torch.empty((H, m, m, B), **kw)
    Ws = torch.empty((H, m, m, B), **kw)
    if B == 0 or H == 0:
        return x, Ls, Ws
    ys = torch.empty((H, m, B), **kw)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        FACTOR_KERNEL.launch("trt_btridiag_factor_launch", D.data_ptr(),
                             U.data_ptr(), b.data_ptr(), x.data_ptr(),
                             Ls.data_ptr(), Ws.data_ptr(), ys.data_ptr(), H,
                             m, B,
                             sweep_launch_config(m, B)["lanes_per_block"],
                             stream)
    return x, Ls, Ws


def solve_lanes_subst(L: torch.Tensor, W: torch.Tensor, b: torch.Tensor):
    """Substitution-only re-solve of a factored system with a fresh
    right-hand side: L, W (H, m, m, B) from ``solve_lanes_factor``, b
    (H, m, B) -> x (H, m, B); m in 2..16 even on the card."""
    if L.dim() != 4 or L.shape[1] != L.shape[2]:
        raise ValueError("L must be (H, m, m, B), got %s" % (tuple(L.shape),))
    H, m, _, B = L.shape
    if tuple(W.shape) != (H, m, m, B) or tuple(b.shape) != (H, m, B):
        raise ValueError("W must be %s and b %s, got %s and %s"
                         % ((H, m, m, B), (H, m, B), tuple(W.shape),
                            tuple(b.shape)))
    if len({L.device, W.device, b.device}) != 1:
        raise ValueError("L, W and b must be on one device")
    if L.device.type == "cpu":
        return solve_lanes_subst_core(L, W, b)
    _check_cuda("solve_lanes_subst", L, W, b, keys=("L", "W", "b"))
    _check_m(m)
    x = torch.empty((H, m, B), dtype=torch.float32, device=L.device)
    if B == 0 or H == 0:
        return x
    return _launch_subst(L, W, b, x, subst_launch_config(m, B, H))


def _launch_subst(L, W, b, x, launch: dict):
    """The substitution's launch at ``launch``'s lanes a block and
    ``keep_lw`` (checked CUDA inputs, x its output); a lane's result
    depends on neither."""
    H, m, _, B = L.shape
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream().cuda_stream
        SUBST_KERNEL.launch("trt_btridiag_subst_launch", L.data_ptr(),
                            W.data_ptr(), b.data_ptr(), x.data_ptr(), H, m,
                            B, launch["lanes_per_block"],
                            int(launch["keep_lw"]), stream)
    return x


def solve_lanes_sweep(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor,
                      bwd_trsv: bool = False):
    """Block-tridiagonal SPD solve through the sweep that keeps L and y
    only, with the trsm or (``bwd_trsv``) the trsv backward tail; m in
    2..16 even on the card (see module doc)."""
    _check(D, U, b)
    if D.device.type == "cpu":
        return solve_lanes_core(D, U, b)
    _check_cuda("solve_lanes_sweep", D, U, b)
    H, m, _, B = D.shape
    _check_m(m)
    x = torch.empty((H, m, B), dtype=torch.float32, device=D.device)
    if B == 0 or H == 0:
        return x
    Ls = torch.empty((H, B, m, m), dtype=torch.float32, device=D.device)
    ys = torch.empty((H, B, m), dtype=torch.float32, device=D.device)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        SWEEP_KERNEL.launch("trt_btridiag_sweep_launch", D.data_ptr(),
                            U.data_ptr(), b.data_ptr(), x.data_ptr(),
                            Ls.data_ptr(), ys.data_ptr(), H, m, B,
                            int(bool(bwd_trsv)),
                            sweep_launch_config(m, B)["lanes_per_block"],
                            stream)
    return x


def solve_lanes_cr(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor):
    """Block-tridiagonal SPD solve by block cyclic reduction; m in 2..16
    even on the card (see module doc)."""
    _check(D, U, b)
    if D.device.type == "cpu":
        return solve_lanes_bcr(D, U, b)
    _check_cuda("solve_lanes_cr", D, U, b)
    H, m, _, B = D.shape
    _check_m(m)
    if B == 0 or H == 0:
        return torch.empty((H, m, B), dtype=torch.float32, device=D.device)
    return _launch_cr(D, U, b, cr_launch_config(m, B, H))


def _launch_cr(D, U, b, launch: dict):
    """Cyclic reduction at ``launch``'s lanes a block and threads (checked
    CUDA inputs); a lane's result depends on neither."""
    H, m, _, B = D.shape
    H2 = launch["H2"]
    kw = dict(dtype=torch.float32, device=D.device)
    x = torch.empty((H2, m, B), **kw)
    work = max(H2 - 1, 1)                   # the levels' systems after 0
    A, C = (torch.empty((H2, B, m, m), **kw) for _ in range(2))
    beta = torch.empty((H2, B, m), **kw)
    Dw, Uw = (torch.empty((work, B, m, m), **kw) for _ in range(2))
    bw = torch.empty((work, B, m), **kw)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        CR_KERNEL.launch("trt_btridiag_cr_launch", D.data_ptr(), U.data_ptr(),
                         b.data_ptr(), x.data_ptr(), A.data_ptr(),
                         C.data_ptr(), beta.data_ptr(), Dw.data_ptr(),
                         Uw.data_ptr(), bw.data_ptr(), H, H2, m, B,
                         launch["lanes_per_block"], launch["threads"], stream)
    return x[:H]
