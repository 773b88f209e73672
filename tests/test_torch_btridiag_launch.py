"""The launch shapes that the block-tridiagonal wrappers pick on the host:
the sweeps' (``sweep_launch_config``: W-persisting, factor and L-and-y)
and block cyclic reduction's (``cr_launch_config``): for every
instantiated m and a range of batches (and horizons), a block the card
accepts (whole groups of a power of two >= m, a whole number of warps, at
most 232,448 bytes of shared memory, K11's bytes the source's formula) and
a grid whose blocks cover the batch; NotImplementedError, not a bad
launch, for an m the kernels are not built for or a block past the
card."""
import re
from pathlib import Path

import pytest

from torch_robotics_tpu_torch.ops.btridiag_kernel import (
    _KERNEL_M, cr_launch_config, sweep_launch_config)


@pytest.mark.parametrize("B", [1, 100, 256, 1024])
@pytest.mark.parametrize("m", _KERNEL_M)
def test_sweep_launch_config_fits_the_card(m, B):
    cfg = sweep_launch_config(m, B)
    g, lanes = cfg["group"], cfg["lanes_per_block"]
    assert g >= m and g & (g - 1) == 0 and 32 % g == 0
    assert cfg["threads"] == g * lanes <= 1024
    assert cfg["threads"] % 32 == 0
    assert cfg["smem_bytes"] <= 232448
    assert cfg["grid"] * lanes >= B > (cfg["grid"] - 1) * lanes


SMEM_MAX = 232448
CR_SOURCE = (Path(__file__).resolve().parents[1] / "torch_robotics_tpu_torch"
             / "csrc" / "btridiag_cr.cu")


def cr_smem_floats(m, groups, lanes):
    """btridiag_cr.cu's cr_smem_floats with its group and slot sizes, read
    from the source and evaluated in Python."""
    text = CR_SOURCE.read_text()

    def body(name):
        expr = re.search(name + r"\([^)]*\)\s*\{\s*return (.*?);\s*\}", text,
                         re.S).group(1)
        return re.sub(r"static_cast<size_t>\(([^)]*)\)", r"(\1)",
                      " ".join(expr.split()))
    env = dict(M=m, groups=groups, lanes=lanes)
    env["group_floats"] = lambda M: eval(body("group_floats"), {}, dict(M=M))
    env["slot_floats"] = lambda M: eval(body("slot_floats"), {}, dict(M=M))
    return eval(body("cr_smem_floats"), {}, env)


@pytest.mark.parametrize("B", [1, 100, 1024, 4096])
@pytest.mark.parametrize("m", _KERNEL_M)
def test_sweep_launch_config_takes_the_l_and_y_sweep(m, B):
    """The L-and-y sweep (K3) launches as the W-persisting sweep: whole
    warps of groups, a block the card takes, a grid that covers B; its
    backward stage (L_k, y_k, U_k) fits the forward's stage."""
    cfg = sweep_launch_config(m, B)
    g, lanes = cfg["group"], cfg["lanes_per_block"]
    assert cfg["threads"] == g * lanes and cfg["threads"] % 32 == 0
    assert cfg["threads"] <= 128 and cfg["smem_bytes"] <= SMEM_MAX
    assert cfg["grid"] * lanes >= B > (cfg["grid"] - 1) * lanes
    forward = m * m * (lanes + 1) + m * lanes + m * m
    assert lanes * m * m + lanes * m + m * m <= forward


@pytest.mark.parametrize("H", [2, 48, 64, 256])
@pytest.mark.parametrize("B", [1, 100, 1024, 4096])
@pytest.mark.parametrize("m", _KERNEL_M)
def test_cr_launch_config_fits_the_card(m, B, H):
    """Block cyclic reduction (K11): whole warps of groups of the power of
    two >= m, at most 256 threads, the shared bytes the source's, within
    the H100's 232,448, a grid whose lane tiles cover B, at least two
    blocks an SM where B allows, and H2 the padded horizon."""
    cfg = cr_launch_config(m, B, H)
    g, lanes, t = cfg["group"], cfg["lanes_per_block"], cfg["threads"]
    assert g >= m and g & (g - 1) == 0 and g // 2 < max(m, 2)
    assert t % 32 == 0 and t % g == 0 and 32 <= t <= 256
    assert cfg["smem_bytes"] == 4 * cr_smem_floats(m, t // g, lanes)
    assert cfg["smem_bytes"] <= SMEM_MAX
    assert cfg["grid"] * lanes >= B > (cfg["grid"] - 1) * lanes
    assert lanes == 1 or cfg["grid"] >= 2 * 132
    H2 = cfg["H2"]
    assert H2 >= H > H2 // 2 and H2 & (H2 - 1) == 0


@pytest.mark.parametrize("m", [1, 3, 15, 18, 40])
def test_launch_configs_refuse_an_m_not_built(m):
    with pytest.raises(NotImplementedError):
        sweep_launch_config(m, 1024)
    with pytest.raises(NotImplementedError):
        cr_launch_config(m, 1024, 64)


@pytest.mark.parametrize("lanes, threads", [
    (1, 512), (1, 96 + 8), (0, 256), (1, 16), (4000, 256), (900, 128)])
def test_cr_launch_config_refuses_a_block_past_the_card(lanes, threads):
    """Past 256 threads, threads not whole warps or groups, no lanes, or a
    ring of slots past the block's shared memory: NotImplementedError, not
    a launch the card refuses."""
    with pytest.raises(NotImplementedError):
        cr_launch_config(14, 4096, 64, lanes=lanes, threads=threads)
