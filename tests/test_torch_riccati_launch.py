"""The launch shapes that the Riccati sweep's and the line-search
rollout's wrappers pick on the host (``riccati_launch_config``,
``rollout_launch_config``): for every joint count d, row count P (the
sweep) or step-size count A (the rollout) and a range of batches, a block
the card accepts (at most 1024 threads, whole groups of a power of two >=
2 d or >= d, a whole number of warps, at most 232,448 bytes of shared
memory) and a grid whose blocks cover the batch; at the iLQR path's B =
512 the sweep gives every SM a block and the rollout takes its widest
copy; above the caps the wrappers raise before any launch."""
import pytest
import torch

from torch_robotics_tpu_torch.ops.riccati_kernel import (
    MAX_DOF, riccati_backward_kernel_factory, riccati_launch_config,
    riccati_p_cap, rollout_launch_config)

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


@pytest.mark.parametrize("B", [1, 100, 512, 4096])
@pytest.mark.parametrize("A", [1, 5, 12, 40])
@pytest.mark.parametrize("d", _DOFS)
def test_rollout_launch_config_fits_the_card(d, A, B):
    """A group of the power of two >= d threads a (lane, step size), whole
    warps, lanes a block that divide B (a row of them is one 4, 8 or
    16-byte copy), the ring's 8 slots of a step's Ks, U, ks and xs rows (2
    d^2 + 4 d floats a lane) within a block's shared memory, a grid
    covering B; many step sizes (A = 40 at d = 8: 4 lanes would take 1280
    threads) take fewer lanes a block."""
    cfg = rollout_launch_config(d, A, B)
    g, lanes = cfg["group"], cfg["lanes_per_block"]
    assert g >= d and g & (g - 1) == 0 and (d == 1 or g < 2 * d)
    assert lanes in (1, 2, 4) and B % lanes == 0
    assert cfg["threads"] % 32 == 0
    assert cfg["threads"] - 32 < lanes * A * g <= cfg["threads"] <= 1024
    assert cfg["smem_bytes"] == 4 * 8 * (2 * d * d + 4 * d) * lanes
    assert cfg["smem_bytes"] <= 232448
    assert cfg["grid"] * lanes == B
    wider = {1: 2, 2: 4}.get(lanes)
    if wider and B % wider == 0:          # the next width passes 1024
        assert -(-wider * A * g // 32) * 32 > 1024


@pytest.mark.parametrize("d", _DOFS)
def test_rollout_launch_config_takes_the_widest_copy(d):
    """At the iLQR path's and the tracking loop's B = 512 with its 5 step
    sizes, 4 lanes a block (one 16-byte copy a row; faster than 2 lanes at
    T = 31 and T = 15 in turns on the H100, PERF.md); the most of 4, 2
    and 1 that divides B and the inputs' alignment allows."""
    assert rollout_launch_config(d, 5, 512)["lanes_per_block"] == 4
    assert rollout_launch_config(d, 5, 4096)["lanes_per_block"] == 4
    assert rollout_launch_config(d, 5, 100)["lanes_per_block"] == 4
    assert rollout_launch_config(d, 5, 512, align=2)["lanes_per_block"] == 2
    assert rollout_launch_config(d, 5, 510)["lanes_per_block"] == 2
    assert rollout_launch_config(d, 5, 512, align=1)["lanes_per_block"] == 1
    assert rollout_launch_config(d, 5, 509)["lanes_per_block"] == 1


def test_rollout_launch_config_raises_past_the_caps():
    """A block of one lane past 1024 threads raises, and so does a given
    lane count past it; so do d past MAX_DOF and lanes a block that are
    not 1, 2 or 4, do not divide B or pass the inputs' alignment."""
    with pytest.raises(NotImplementedError, match="threads"):
        rollout_launch_config(8, 129, 512)                  # 1032 threads
    with pytest.raises(NotImplementedError, match="threads"):
        rollout_launch_config(8, 40, 512, lanes=4)          # 1280 threads
    with pytest.raises(NotImplementedError, match="joints"):
        rollout_launch_config(MAX_DOF + 1, 5, 512)
    for lanes, B, align in ((3, 512, 4), (4, 514, 4), (4, 512, 2)):
        with pytest.raises(ValueError, match="lanes"):
            rollout_launch_config(7, 5, B, lanes=lanes, align=align)


@pytest.mark.parametrize("d, A", [(MAX_DOF + 1, 5), (8, 129)])
def test_rollout_wrapper_raises_before_any_launch(monkeypatch, d, A):
    """On the card (here: the wrapper's device check made to say so), a d
    above MAX_DOF or a block of one lane past 1024 threads raises
    NotImplementedError before the kernel is touched."""
    from torch_robotics_tpu_torch.ops import riccati_kernel as rk

    class NoLaunch:
        def launch(self, *args):
            raise AssertionError("the kernel was launched")

    monkeypatch.setattr(rk, "_check", lambda *args: True)
    monkeypatch.setattr(rk, "ROLLOUT_KERNEL", NoLaunch())
    T, B, m = 3, 512, 2 * d
    roll = rk.linesearch_rollout_kernel_factory(
        d, m, T, 0.04, tuple(0.9 ** k for k in range(A)))
    ins = (torch.zeros((T + 1, m, B)), torch.zeros((T, d, B)),
           torch.zeros((T, d, B)), torch.zeros((T, d, m, B)))
    with pytest.raises(NotImplementedError):
        roll(*ins)
