"""The substitution kernel of csrc/btridiag.cu (``btridiag_subst_kernel``, a
group of threads per lane) without a GPU: its launch shape
(``subst_launch_config``) against the source's shared-memory formula, and
a torch model of the kernel's order of operations (a column-oriented
forward substitution with one division a pivot and the next step's W^T y
summed over the same broadcasts, then the sweep's backward pass: a
reciprocal pivot and a column-oriented L^-T) held to the plain version in
float64 and to the JAX package's ``solve_lanes_pallas_subst`` in
interpret mode in float32, on the same numpy inputs.

Tolerances: float64 model vs float64 plain 1e-12 of max|x| (the same
algebra in another order); float32 model vs the JAX kernel 1e-5 of max|x|
as tests/test_torch_btridiag_reuse.py (float32 op order: the TPU kernel
multiplies by reciprocal pivots where the model divides in its forward
pass)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_btridiag import _system
from torch_robotics_tpu.ops.pallas_btridiag import solve_lanes_pallas_subst
from torch_robotics_tpu_torch.ops.btridiag_kernel import (
    _KERNEL_M, subst_launch_config)
from torch_robotics_tpu_torch.solve.btridiag_lanes import (
    solve_lanes_factor_core, solve_lanes_subst_core)

SMEM_MAX = 232448
N_SM = 132
SOURCE = (Path(__file__).resolve().parents[1] / "torch_robotics_tpu_torch"
          / "csrc" / "btridiag.cu")


def cu_smem_floats(m, lanes, H, keep):
    """btridiag.cu's subst_smem_floats, its return expression read from the
    source and evaluated in Python."""
    text = SOURCE.read_text()
    stages = int(re.search(r"constexpr int kSubstStages = (\d+);",
                           text).group(1))
    body = re.search(r"subst_smem_floats\([^)]*\)\s*\{\s*return (.*?);\s*\}",
                     text, re.S).group(1)
    expr = re.sub(r"static_cast<size_t>\(([^)]*)\)", r"(\1)",
                  " ".join(body.split()))
    expr = expr.replace("keep ? H : kSubstStages",
                        "H if keep else kSubstStages")
    return eval(expr, {}, dict(M=m, lanes=lanes, H=H, keep=keep,
                               kSubstStages=stages))


@pytest.mark.parametrize("B", [1, 100, 256, 1024, 4096])
@pytest.mark.parametrize("m", _KERNEL_M)
def test_subst_launch_config(m, B):
    """Whole warps of groups of the power of two >= m; the grid covers B;
    the lanes a block double only while the grid keeps one block an SM;
    the shared bytes are the source's, within the H100's; L and W stay on
    chip by default exactly where the whole grid is then resident (228 KB
    an SM, 1 KB of it reserved a block), and a variant forced on raises
    where its block does not fit."""
    cfg = subst_launch_config(m, B, 32)
    G, lanes = cfg["group"], cfg["lanes_per_block"]
    assert G >= m and G & (G - 1) == 0 and G // 2 < max(m, 2)
    assert cfg["threads"] == G * lanes
    assert cfg["threads"] % 32 == 0 and cfg["threads"] <= 128
    assert cfg["grid"] * lanes >= B > (cfg["grid"] - 1) * lanes
    if lanes * G > 32:
        assert -(-B // lanes) >= N_SM
    if 2 * lanes * G <= 128:
        assert -(-B // (2 * lanes)) < N_SM
    keep = 4 * cu_smem_floats(m, lanes, 32, True)
    assert cfg["keep_lw"] == (keep <= SMEM_MAX and cfg["grid"] <= N_SM * (
        233472 // (keep + 1024)))
    for forced in (False, True):
        try:
            c = subst_launch_config(m, B, 32, keep_lw=forced)
        except NotImplementedError:
            assert forced and keep > SMEM_MAX
            continue
        assert (c["keep_lw"], c["lanes_per_block"]) == (forced, lanes)
        assert c["smem_bytes"] <= SMEM_MAX
        assert c["smem_bytes"] == 4 * cu_smem_floats(m, lanes, 32, forced)
    assert cfg["smem_bytes"] == 4 * cu_smem_floats(m, lanes, 32,
                                                    cfg["keep_lw"])


def test_subst_launch_config_refuses_a_block_that_does_not_fit():
    with pytest.raises(NotImplementedError, match="shared memory"):
        subst_launch_config(16, 256, 2000)
    with pytest.raises(NotImplementedError, match="shared memory"):
        subst_launch_config(14, 256, 128, keep_lw=True)
    # the reuse workload keeps L and W on chip; a batch past one wave not
    assert subst_launch_config(14, 256, 32)["keep_lw"]
    assert not subst_launch_config(14, 4096, 32)["keep_lw"]


def group_subst_model(L, W, b):
    """The substitution kernel's arithmetic in its order, one row (thread)
    of a lane's group a tensor row: L, W (H, m, m, B), b (H, m, B) ->
    x (H, m, B)."""
    H, m, _, B = L.shape
    y = torch.zeros_like(b)
    wy = torch.zeros_like(b[0])
    for k in range(H):
        r = b[k] - wy                          # thread i: b_k[i] - Wy[i]
        for p in range(m):
            yp = r[p] / L[k, p, p]             # thread p's division
            y[k, p] = yp
            r[p + 1:] = r[p + 1:] - L[k, p + 1:, p] * yp
            wy = W[k, 0] * yp if p == 0 else wy + W[k, p] * yp
    x = torch.zeros_like(b)
    for k in reversed(range(H)):
        r = y[k].clone()
        if k < H - 1:
            for c in range(m):                 # r -= W_k x_{k+1}, by column
                r = r - W[k, :, c] * x[k + 1, c]
        inv = 1.0 / torch.diagonal(L[k], dim1=0, dim2=1).T
        for p in reversed(range(m)):           # x_k = L_k^-T r, by column
            x[k, p] = r[p] * inv[p]
            r[:p] = r[:p] - L[k, p, :p] * x[k, p]
    return x


@pytest.mark.parametrize("H, m, B", [(6, 4, 33), (3, 14, 16)])
def test_group_model_is_the_plain_substitution_in_float64(H, m, B):
    D, U, b = _system(H, m, B, seed=40 + m)
    _, L, W = solve_lanes_factor_core(
        *(torch.as_tensor(a, dtype=torch.float64) for a in (D, U, b)))
    b2 = torch.as_tensor(np.random.default_rng(m).normal(size=b.shape))
    got = group_subst_model(L, W, b2)
    ref = solve_lanes_subst_core(L, W, b2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=1e-12 * float(ref.abs().max()))


@pytest.mark.parametrize("H, m, B", [(6, 4, 128), (2, 14, 128)])
def test_group_model_matches_jax_interpret(H, m, B):
    """float32, on the port's factors: the model vs the JAX substitution
    kernel in interpret mode on the same numpy inputs."""
    D, U, b = _system(H, m, B, seed=50 + m)
    _, L, W = solve_lanes_factor_core(*map(torch.as_tensor, (D, U, b)))
    b2 = np.random.default_rng(m + 1).normal(size=b.shape).astype(np.float32)
    jx = np.asarray(solve_lanes_pallas_subst(
        jnp.asarray(L.numpy()), jnp.asarray(W.numpy()), jnp.asarray(b2),
        tile_b=128, interpret=True))
    got = group_subst_model(L, W, torch.as_tensor(b2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jx, rtol=0,
                               atol=1e-5 * float(np.abs(jx).max()))
