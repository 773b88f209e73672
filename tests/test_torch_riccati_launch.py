"""The launch shape that the Riccati sweep's wrapper picks on the host
(``riccati_launch_config``): for every joint count d, row count P and a
range of batches, a block the card accepts (at most 1024 threads, whole
groups of a power of two >= 2 d, a whole number of warps, at most 232,448
bytes of shared memory) and a grid whose blocks cover the batch; above the
row cap the wrapper raises before any launch."""
import pytest
import torch

from torch_robotics_tpu_torch.ops.riccati_kernel import (
    MAX_DOF, riccati_backward_kernel_factory, riccati_launch_config,
    riccati_p_cap)

_DOFS = range(1, MAX_DOF + 1)


@pytest.mark.parametrize("B", [1, 100, 512, 4096])
@pytest.mark.parametrize("P", [1, 27, 200, "cap"])
@pytest.mark.parametrize("d", _DOFS)
def test_riccati_launch_config_fits_the_card(d, P, B):
    if P == "cap":
        P = riccati_p_cap(d)
    cfg = riccati_launch_config(d, P, B)
    g, lanes = cfg["group"], cfg["lanes_per_block"]
    assert g >= 2 * d and g & (g - 1) == 0 and 32 % g == 0
    assert g * lanes % 32 == 0                 # whole compute warps
    assert cfg["threads"] == g * lanes + 32 <= 1024   # and a producer warp
    assert cfg["stages"] in (1, 2)
    assert cfg["smem_bytes"] <= 232448
    # one stage of F_t (2 d P entries), U_t and l_t for each lane at least
    assert cfg["smem_bytes"] >= 4 * cfg["stages"] * lanes * (2 * d * P
                                                             + 3 * d)
    assert cfg["grid"] * lanes >= B > (cfg["grid"] - 1) * lanes


@pytest.mark.parametrize("d", _DOFS)
def test_riccati_launch_config_raises_above_the_cap(d):
    cap = riccati_p_cap(d)
    # 1184 (d = 1) to 2624 (d = 5) rows: far above the iLQR path's 27-34
    assert cap >= 1024
    with pytest.raises(NotImplementedError, match="at most %d rows" % cap):
        riccati_launch_config(d, cap + 1, 512)


def test_riccati_launch_config_reaches_every_sm_and_shrinks_for_large_p():
    """At the iLQR path's shapes the grid covers the H100's 132 SMs; a P
    whose two stages do not fit four lanes takes fewer lanes per block."""
    cfg = riccati_launch_config(7, 27, 512)
    assert cfg["grid"] >= 128 and cfg["stages"] == 2
    big = riccati_launch_config(7, 600, 512)
    assert big["lanes_per_block"] < cfg["lanes_per_block"]


@pytest.mark.parametrize("d, over_cap", [(7, True), (MAX_DOF + 1, False)])
def test_riccati_wrapper_raises_before_any_launch(monkeypatch, d, over_cap):
    """On the card (here: the wrapper's device check made to say so), a P
    above the cap or a d above MAX_DOF raises NotImplementedError before
    the kernel is touched."""
    from torch_robotics_tpu_torch.ops import riccati_kernel as rk

    class NoLaunch:
        def launch(self, *args):
            raise AssertionError("the kernel was launched")

    monkeypatch.setattr(rk, "_check", lambda *args: True)
    monkeypatch.setattr(rk, "RICCATI_KERNEL", NoLaunch())
    T, B = 2, 4
    P = riccati_p_cap(d) + 1 if over_cap else 27
    sweep = rk.riccati_backward_kernel_factory(d, 2 * d, P, T, 0.04, 1e-4,
                                               1e-6, 1e4)
    ins = (torch.zeros((T, d, B)), torch.zeros((T, 2 * d, B)),
           torch.zeros((T, 2 * d, P, B)), torch.zeros((2 * d, B)))
    with pytest.raises(NotImplementedError):
        sweep(*ins)
