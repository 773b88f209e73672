"""The launch shape that the column sweep's wrapper picks on the host
(``cols_launch_config``): for state blocks m from 17 to 64 and a range of
batches, the padded width the kernel is built for (>= m, exact at m = 40),
whole warps of at least 2 m + 1 threads a lane, at most 8 warps a block,
one named barrier id per lane group within the 16 a block has (id 0 left
to the block), at most 232,448 bytes of shared memory and a grid whose
blocks cover the batch; outside 1 <= m <= 64 the wrapper raises before
any launch."""
import pytest
import torch

from torch_robotics_tpu_torch.ops.btridiag_kernel import (_COLS_WIDTHS,
                                                          cols_launch_config)


@pytest.mark.parametrize("B", [1, 100, 256, 4096])
@pytest.mark.parametrize("m", [17, 24, 33, 40, 41, 64])
def test_cols_launch_config_fits_the_card(m, B):
    cfg = cols_launch_config(m, B)
    w, g, lanes = cfg["width"], cfg["group"], cfg["lanes_per_block"]
    assert w in _COLS_WIDTHS and w >= m
    assert g % 32 == 0 and g >= 2 * w + 1 >= 2 * m + 1
    assert g - 32 < 2 * w + 1                  # no warp without a column
    assert cfg["threads"] == g * lanes <= 256  # 8 warps: 255 registers
    ids = cfg["barrier_ids"]
    assert len(ids) == len(set(ids)) == lanes >= 1
    assert all(1 <= i < 16 for i in ids)
    assert cfg["smem_bytes"] <= 232448
    # per lane at least two published columns and the (w + 1) x w hand-off
    assert cfg["smem_bytes"] >= 4 * lanes * (2 * (2 * w + 1) + (w + 1) * w)
    assert cfg["grid"] * lanes >= B > (cfg["grid"] - 1) * lanes


def test_cols_launch_config_takes_the_least_padded_width():
    """Every m in 1..64 runs in the least instantiated width >= m; the
    config-4 path's m = 40 is an exact width."""
    for m in range(1, 65):
        w = cols_launch_config(m, 256)["width"]
        assert w == min(x for x in _COLS_WIDTHS if x >= m)
    assert cols_launch_config(40, 256)["width"] == 40
    assert cols_launch_config(40, 256)["group"] == 96


def test_cols_launch_config_reaches_every_sm():
    """At config 4's B = 256 the blocks cover the H100's 132 SMs at least
    once; a one-lane batch takes one lane a block."""
    cfg = cols_launch_config(40, 256)
    assert cfg["grid"] * cfg["lanes_per_block"] >= 256
    assert cfg["grid"] >= 128
    assert cols_launch_config(40, 1)["lanes_per_block"] == 1


@pytest.mark.parametrize("m", [0, 65])
def test_cols_wrapper_raises_before_any_launch(monkeypatch, m):
    """On the card (here: the wrapper's device check made to say so), an m
    outside 1..64 raises NotImplementedError before the kernel is
    touched."""
    from torch_robotics_tpu_torch.ops import btridiag_kernel as bk

    class NoLaunch:
        def launch(self, *args):
            raise AssertionError("the kernel was launched")

    monkeypatch.setattr(bk, "_check_cuda", lambda *args: None)
    monkeypatch.setattr(bk, "COLS_KERNEL", NoLaunch())
    D = torch.zeros((2, m, m, 3), device="meta")
    U = torch.zeros((2, m, m, 1), device="meta")
    b = torch.zeros((2, m, 3), device="meta")
    with pytest.raises(NotImplementedError):
        bk.solve_lanes_cols(D, U, b)
