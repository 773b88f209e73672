"""Batch sharding over devices and processes (counterpart of
torch_robotics_tpu/parallel/mesh.py).

A mesh is an ordered list of this process's torch devices (by default
every visible CUDA device).  A sharded batch is split along its leading
axis into one share per mesh entry; each share runs the plain solver on its
device, and the results are gathered onto the mesh's first device.  The
reference's ``psum`` / ``pmean`` statistic becomes a sum over the shares
and, once ``multihost_init`` has started a process group, an
``all_reduce`` over the processes.  The solvers take either the shares
(``shard_batch``) or one whole tensor, which they split themselves.

A residual function holds its task's tensors on one device, so a mesh of
several devices takes one residual function per mesh entry (a task built on
each device) where the entries differ; a single function serves a mesh
whose entries are one device.

Large shares can run as sequential chunks (``_chunked``): the reference's
throughput knee on its chips (``_POD_CHUNK`` = 256 scenarios) is kept as
the MPC wrapper's default, so the same call gives the same schedule.
"""
from __future__ import annotations

import warnings
from typing import Callable, List, Optional, Sequence

import torch

__all__ = ["make_mesh", "shard_batch", "shard_batch_padded", "replicate",
           "multihost_init", "solve_sharded", "mpc_rollout_sharded",
           "ilqr_solve_sharded", "sgpmp_solve_sharded",
           "chomp_solve_sharded"]

# the reference's per-device chunk for MPC (its single-chip throughput
# knee); shares larger than this that it divides run chunk by chunk
_POD_CHUNK = 256


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "batch",
              devices=None) -> List[torch.device]:
    """1-D mesh over the scenario batch axis: ``devices`` (names or torch
    devices; default every visible CUDA device), the first ``n_devices``
    of them.  ``axis_name`` is accepted for the reference's signature."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=['cpu', ...] for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(dv) for dv in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    return devices


def multihost_init(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None) -> None:
    """Join a ``torch.distributed`` process group (no-op for a single
    process): ``coordinator_address`` "host:port" (or a full init URL),
    the world size and this process's rank.  ``backend`` is the one for
    the meshes this process shards over: "gloo" for CPU devices, "nccl"
    for CUDA ones (None: nccl where CUDA is visible, else gloo).  Under
    nccl the process's current card becomes ``process_id`` modulo the
    visible cards, so processes of one host, ranked host by host, one for
    each card, each hold their own (give each its mesh, e.g.
    ``make_mesh(devices=[torch.cuda.current_device()])``)."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = (coordinator_address if "://" in coordinator_address
           else "tcp://" + coordinator_address)
    dist.init_process_group(backend=backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def _process_group():
    """(rank, world size) of the process group, (0, 1) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the processes of the group (itself without one), on
    the backend's device, returned on t's."""
    import torch.distributed as dist
    if _process_group()[1] == 1:
        return t
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    buf = t.detach().to(dev).clone()
    dist.all_reduce(buf)
    return buf.to(t.device)


def shard_batch(x, mesh: Sequence[torch.device], axis_name: str = "batch"):
    """Split x along its leading axis into one share per mesh entry, each
    on its device -> list of shares.  The batch must divide evenly (use
    ``shard_batch_padded`` otherwise)."""
    n = len(mesh)
    if x.shape[0] % n:
        raise ValueError("a batch of %d does not divide over %d devices; use "
                         "shard_batch_padded" % (x.shape[0], n))
    return [s.to(dv) for s, dv in zip(torch.chunk(x, n, dim=0), mesh)]


def replicate(x, mesh: Sequence[torch.device]):
    """One copy of x on each mesh device -> list."""
    return [x.to(dv) for dv in mesh]


def shard_batch_padded(x, mesh: Sequence[torch.device],
                       axis_name: str = "batch"):
    """Shard a batch whose size need not divide the mesh size: the leading
    axis is padded by repeating its last element up to the next multiple
    (repeats keep the solvers' numbers finite, unlike zero rows) -> (shares,
    n_valid).  Pass n_valid to a solver to leave the padded tail out of its
    statistics."""
    n = len(mesh)
    B = x.shape[0]
    pad = (-B) % n
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])], dim=0)
    return shard_batch(x, mesh, axis_name), B


def _shares(x, mesh):
    """Batch-leading operand -> one share per mesh entry on its device."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(mesh):
            raise ValueError("%d shares for a mesh of %d devices"
                             % (len(x), len(mesh)))
        return [s.to(dv) for s, dv in zip(x, mesh)]
    return shard_batch(x, mesh)


def _endpoint_shares(x, mesh):
    """Start or goal states: per-problem (B, 2d) (or its shares) are
    sharded, one shared (2d,) state is replicated."""
    if isinstance(x, (list, tuple)) or x.dim() > 1:
        return _shares(x, mesh)
    return replicate(x, mesh)


def _per_row(x, n: int):
    """A shared (2d,) state broadcast to n rows; per-row states as they
    are (the chunks slice them with the batch)."""
    return x if x.dim() > 1 else x.expand((n,) + x.shape)


def _residual_fns(residual_fn, mesh):
    if isinstance(residual_fn, (list, tuple)):
        if len(residual_fn) != len(mesh):
            raise ValueError("%d residual functions for a mesh of %d devices"
                             % (len(residual_fn), len(mesh)))
        return list(residual_fn)
    if len(set(mesh)) > 1:
        raise ValueError("a mesh of several devices takes one residual "
                         "function per mesh entry (a task on each device)")
    return [residual_fn] * len(mesh)


def _gather(parts, mesh):
    """The shares' results concatenated on the mesh's first device."""
    return torch.cat([p.to(mesh[0]) for p in parts])


def _valid_rows(share: int, B_l: int, n_shares: int, n_valid, device):
    """Row mask of one share (its global rows counted over the process
    group's shares, rank-major) -> float (B_l,)."""
    rank, _ = _process_group()
    if n_valid is None:
        return torch.ones(B_l, device=device)
    row0 = (rank * n_shares + share) * B_l
    return ((row0 + torch.arange(B_l, device=device)) < n_valid).float()


def _masked_mean(costs: Sequence[torch.Tensor], n_valid, mesh):
    """Global mean of the shares' per-problem costs over every share of
    every process, the rows at or past ``n_valid`` (padding) left out."""
    total = torch.zeros(2, dtype=torch.float64, device=mesh[0])
    for i, c in enumerate(costs):
        valid = _valid_rows(i, c.shape[0], len(costs), n_valid, c.device)
        total += torch.stack([torch.sum(c.double() * valid),
                              torch.sum(valid).double()]).to(mesh[0])
    total = _all_reduce_sum(total)
    return (total[0] / total[1]).to(costs[0].dtype)


def _chunked(body: Callable, args: Sequence[torch.Tensor],
             chunk: Optional[int]):
    """Run ``body`` over a share as sequential chunks of ``chunk`` problems
    when the share exceeds ``chunk`` and divides evenly, else in one call
    (with a warning when a chunk was asked for and does not divide it).
    ``body`` takes and returns tuples of tensors, each batch-leading; it
    also gets the chunk's index."""
    B_l = args[0].shape[0]
    if chunk and B_l > chunk:
        if B_l % chunk == 0:
            outs = [body(tuple(a[i:i + chunk] for a in args), i // chunk)
                    for i in range(0, B_l, chunk)]
            return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))
        warnings.warn("a share of %d problems does not divide into chunks "
                      "of %d: it runs in one call" % (B_l, chunk))
    return body(tuple(args), 0)


def solve_sharded(residual_fn, theta0, start_state, goal_state, params,
                  mesh: Sequence[torch.device], axis_name: str = "batch",
                  n_valid: Optional[int] = None):
    """GPMP2 solve with the problem batch sharded over the mesh.

    theta0 (B, H, 2d) or its shares; start/goal shared (2d,) or per-problem
    (B, 2d).  -> (trajectories (B, H, 2d) on the mesh's first device, the
    global mean final cost over every process, padded rows excluded)."""
    from ..solve.gpmp2 import gpmp2_solve
    fns = _residual_fns(residual_fn, mesh)
    ths = _shares(theta0, mesh)
    ss, gs = _endpoint_shares(start_state, mesh), _endpoint_shares(
        goal_state, mesh)
    res = [gpmp2_solve(f, th, s, g, params)
           for f, th, s, g in zip(fns, ths, ss, gs)]
    return (_gather([r.trajs for r in res], mesh),
            _masked_mean([r.costs for r in res], n_valid, mesh))


def mpc_rollout_sharded(residual_fn, start_state, goal_state, params,
                        n_steps, mesh: Sequence[torch.device],
                        axis_name: str = "batch",
                        chunk: Optional[int] = _POD_CHUNK):
    """Receding-horizon MPC with the scenario batch sharded over the mesh.

    start/goal (B, 2d) or their shares.  Each share runs ``mpc_rollout``,
    as sequential chunks of ``chunk`` scenarios where the share exceeds it
    and divides evenly (None: one call) -> (executed states (B, n_steps,
    2d) on the mesh's first device, the global fraction of scenarios whose
    final distance to the goal is below 0.1)."""
    from ..solve.mpc import mpc_rollout
    fns = _residual_fns(residual_fn, mesh)
    ss, gs = _shares(start_state, mesh), _shares(goal_state, mesh)
    xs, reached = [], []
    for f, s, g in zip(fns, ss, gs):
        def body(a, _, f=f):
            x, info = mpc_rollout(f, a[0], a[1], params, n_steps)
            return x, info["dist_to_goal"][-1]
        x, dist = _chunked(body, (s, g), chunk)
        xs.append(x)
        reached.append((dist < 0.1).float())
    return _gather(xs, mesh), _masked_mean(reached, None, mesh)


def ilqr_solve_sharded(residual_fn, start_state, goal_state, params,
                       mesh: Sequence[torch.device],
                       axis_name: str = "batch", u_init=None, x_ref=None,
                       q_limits=None, n_valid: Optional[int] = None,
                       chunk: Optional[int] = None):
    """iLQR solve with the problem batch sharded over the mesh.

    start/goal (B, 2d); optional warm-start controls ``u_init`` (B, H-1, d)
    and tracking reference ``x_ref`` (B, H, 2d) shard alongside (or come as
    shares); ``q_limits`` (q_min, q_max) is shared.  ``chunk`` as in
    ``mpc_rollout_sharded`` (default None: one call a share).  -> (an
    ``ILQRResult`` gathered on the mesh's first device, the global mean
    final cost, padded rows excluded)."""
    from ..solve.ilqr import ILQRResult, ilqr_solve
    fns = _residual_fns(residual_fn, mesh)
    ss, gs = _shares(start_state, mesh), _shares(goal_state, mesh)
    us = _shares(u_init, mesh) if u_init is not None else [None] * len(mesh)
    rs = _shares(x_ref, mesh) if x_ref is not None else [None] * len(mesh)
    names = [k for k, v in (("u_init", u_init), ("x_ref", x_ref))
             if v is not None]
    outs = []
    for f, s, g, u0, ref, dv in zip(fns, ss, gs, us, rs, mesh):
        qlim = (None if q_limits is None
                else (q_limits[0].to(dv), q_limits[1].to(dv)))

        def body(a, _, f=f, qlim=qlim):
            r = ilqr_solve(f, a[0], a[1], params, q_limits=qlim,
                           **dict(zip(names, a[2:])))
            return r.trajs, r.controls, r.costs, r.cost_trace.T
        outs.append(_chunked(body, [s, g] + [a for a in (u0, ref)
                                             if a is not None], chunk))
    trajs, controls, costs, trace_b = (
        _gather([o[k] for o in outs], mesh) for k in range(4))
    return (ILQRResult(trajs=trajs, controls=controls, costs=costs,
                       cost_trace=trace_b.T),
            _masked_mean([o[2] for o in outs], n_valid, mesh))


def _fold_seed(seed: int, *indices: int) -> int:
    """A generator seed derived from ``seed`` and the indices (the
    reference's fold_in): distinct indices give distinct streams."""
    h = seed & 0xFFFFFFFFFFFFFFFF
    for i in indices:
        h = (h * 6364136223846793005 + 1442695040888963407 + i) \
            & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 29
    return h & 0x7FFFFFFFFFFFFFFF


def sgpmp_solve_sharded(residual_fn, theta0, start_state, goal_state, params,
                        mesh: Sequence[torch.device],
                        generator: Optional[torch.Generator] = None,
                        axis_name: str = "batch",
                        n_valid: Optional[int] = None,
                        chunk: Optional[int] = None):
    """Stochastic GPMP solve sharded over the mesh.

    Each (share, chunk) draws its normals from its own generator on its
    device, seeded from ``generator``'s seed (None: 0) and the share's
    global index and the chunk's (the reference's ``fold_in(key,
    axis_index)`` and per-chunk fold): results are statistically
    equivalent to, not bit for bit, the unsharded solve.  -> (an
    ``SGPMPResult`` gathered on the mesh's first device, the global mean
    final cost, padded rows excluded)."""
    from ..solve.sampling import SGPMPResult, sgpmp_solve
    seed = 0 if generator is None else generator.initial_seed()
    rank, _ = _process_group()
    fns = _residual_fns(residual_fn, mesh)
    ths = _shares(theta0, mesh)
    ss, gs = _endpoint_shares(start_state, mesh), _endpoint_shares(
        goal_state, mesh)
    outs = []
    for i, (f, th, s, g, dv) in enumerate(zip(fns, ths, ss, gs, mesh)):
        B_l = th.shape[0]

        def body(a, c, f=f, dv=dv, share=rank * len(mesh) + i):
            gen = torch.Generator(device=dv).manual_seed(
                _fold_seed(seed, share, c))
            r = sgpmp_solve(f, a[0], a[1], a[2], params, generator=gen)
            return r.trajs, r.cost_trace.T
        outs.append(_chunked(body, (th, _per_row(s, B_l), _per_row(g, B_l)),
                             chunk))
    trajs = _gather([o[0] for o in outs], mesh)
    trace_b = _gather([o[1] for o in outs], mesh)
    return (SGPMPResult(trajs=trajs, cost_trace=trace_b.T),
            _masked_mean([o[1][:, -1] for o in outs], n_valid, mesh))


def chomp_solve_sharded(residual_fn, theta0, start_state, goal_state, params,
                        mesh: Sequence[torch.device],
                        axis_name: str = "batch",
                        n_valid: Optional[int] = None,
                        chunk: Optional[int] = None):
    """CHOMP solve sharded over the mesh (deterministic: per problem the
    unsharded solve's result).  -> (a ``CHOMPResult`` whose ``cost_trace``
    keeps CHOMP's batch-summed (iters,) meaning, summed over every share
    of every process, the global mean final cost per problem); with
    ``n_valid`` the padded rows are left out of both statistics."""
    from ..solve.chomp import CHOMPResult, chomp_solve
    fns = _residual_fns(residual_fn, mesh)
    ths = _shares(theta0, mesh)
    ss, gs = _endpoint_shares(start_state, mesh), _endpoint_shares(
        goal_state, mesh)
    trajs, traces = [], []
    for i, (f, th, s, g) in enumerate(zip(fns, ths, ss, gs)):
        B_l = th.shape[0]

        def body(a, _, f=f):
            r = chomp_solve(f, a[0], a[1], a[2], params,
                            per_problem_trace=True)
            return r.trajs, r.cost_trace.T
        t, trace_b = _chunked(body, (th, _per_row(s, B_l), _per_row(g, B_l)),
                              chunk)
        valid = _valid_rows(i, B_l, len(mesh), n_valid, trace_b.device)
        trajs.append(t)
        traces.append(trace_b * valid[:, None].to(trace_b.dtype))
    trace_g = _all_reduce_sum(torch.stack(
        [tb.sum(dim=0).to(mesh[0]) for tb in traces]).sum(dim=0))
    return (CHOMPResult(trajs=_gather(trajs, mesh), cost_trace=trace_g),
            _masked_mean([tb[:, -1] for tb in traces], n_valid, mesh))
