"""The launch shape that the W-persisting and factor sweeps' wrapper picks
on the host (``sweep_launch_config``): for every instantiated m and a range
of batches, a block the card accepts (at most 1024 threads, whole groups of
a power of two >= m, a whole number of warps, at most 232,448 bytes of
shared memory) and a grid whose blocks cover the batch."""
import pytest

from torch_robotics_tpu_torch.ops.btridiag_kernel import (_KERNEL_M,
                                                          sweep_launch_config)


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
