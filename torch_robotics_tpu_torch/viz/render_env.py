"""Environment rendering: objects, SDF contours, SDF gradient quivers
(counterpart of torch_robotics_tpu/viz/render_env.py).  The SDF is
evaluated on the environment's device in one batched call, its gradient
by autograd through the same call, and drawn from host copies."""
from __future__ import annotations

import numpy as np
import torch

from ..core.utils import to_numpy


def create_fig_and_axes(dim: int = 2, figsize=(8, 8)):
    import matplotlib.pyplot as plt
    if dim == 3:
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(projection="3d")
    else:
        fig, ax = plt.subplots(figsize=figsize)
    return fig, ax


def _set_limits(env, ax):
    lim = to_numpy(env.limits)
    ax.set_xlim(lim[0][0], lim[1][0])
    ax.set_ylim(lim[0][1], lim[1][1])
    if env.dim == 3:
        ax.set_zlim(lim[0][2], lim[1][2])
        ax.set_zlabel("z")
    ax.set_aspect("equal")
    ax.set_xlabel("x")
    ax.set_ylabel("y")


def render_env(env, ax=None):
    for obj in env.obj_fixed_list:
        obj.render(ax)
    if env.obj_extra_list is not None:
        for obj in env.obj_extra_list:
            obj.render(ax, color="red", cmap="Reds")
    _set_limits(env, ax)


def _grid_points(env, steps):
    """'xy' meshgrid of ``steps`` points an axis over the limits (numpy)
    and its points (steps^dim, dim) as float32 on the env's device."""
    lim = to_numpy(env.limits)
    axes = [np.linspace(lim[0][d], lim[1][d], steps) for d in range(env.dim)]
    mesh = np.meshgrid(*axes, indexing="xy")
    pts = torch.as_tensor(np.stack([m.reshape(-1) for m in mesh], axis=-1),
                          dtype=torch.float32, device=env.device)
    return mesh, pts


def render_env_sdf(env, ax=None, fig=None, steps=200):
    mesh, pts = _grid_points(env, steps)
    sdf = to_numpy(env.compute_sdf(pts)).reshape(mesh[0].shape)
    if env.dim == 3:
        idxs = np.argwhere(sdf < 0)
        if len(idxs) > 5000:
            idxs = idxs[np.random.choice(len(idxs), 5000, replace=False)]
        ax.scatter(mesh[0][tuple(idxs.T)], mesh[1][tuple(idxs.T)],
                   mesh[2][tuple(idxs.T)])
    else:
        ctf = ax.contourf(mesh[0], mesh[1], sdf)
        if fig is not None:
            fig.colorbar(ctf, orientation="vertical")
    _set_limits(env, ax)


def render_env_grad_sdf(env, ax=None, fig=None, steps=40):
    mesh, pts = _grid_points(env, steps)
    pts.requires_grad_(True)
    # each point's SDF reads that point alone: the gradient of the sum is
    # every point's gradient
    grad = to_numpy(torch.autograd.grad(env.compute_sdf(pts).sum(), pts)[0])
    flats = [m.reshape(-1) for m in mesh]
    if env.dim == 3:
        ax.quiver(flats[0], flats[1], flats[2], grad[:, 0], grad[:, 1],
                  grad[:, 2], length=0.1, normalize=True, color="red")
    else:
        ax.quiver(flats[0], flats[1], grad[:, 0], grad[:, 1], color="red")
    _set_limits(env, ax)
