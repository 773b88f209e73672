"""The launch shapes that the Riccati sweep's and the line-search
rollout's wrappers pick on the host (``riccati_launch_config``,
``rollout_launch_config``): for every joint count d in 1..64, row count P
(the sweep) or step-size count A (the rollout) and a range of batches, a
block the card accepts (at most 1024 threads, whole groups of a power of
two >= 2 d or >= d, a whole number of warps, at most 232,448 bytes of
shared memory) and a grid whose blocks cover the batch; the route by d
(registers to 8 joints, shared memory past them); at the iLQR path's B =
512 the sweep gives every SM a block and the rollout takes its widest
copy; above the caps the wrappers raise before any launch."""
import pytest
import torch

from torch_robotics_tpu_torch.ops.riccati_kernel import (
    MAX_DOF, NARROW_MAX_DOF, riccati_backward_kernel_factory,
    riccati_launch_config, riccati_p_cap, rollout_launch_config)

_DOFS = range(1, MAX_DOF + 1)
_SMEM = 232448


def _lane_floats(d):
    """What a lane of the shared route keeps in shared memory across steps
    at least: S (m x m), G = S B (m x d), R11, R12 (d x d, d x m)."""
    m = 2 * d
    return m * m + m * d + d * d + d * m


_BATCHES = (1, 100, 512, 4096)


@pytest.mark.parametrize("P", [1, 27, 200, "cap"])
@pytest.mark.parametrize("d", _DOFS)
def test_riccati_launch_config_fits_the_card(d, P):
    cap = riccati_p_cap(d)
    if P == "cap":
        P = cap
    for B in _BATCHES:
        if P > cap:                # d >= 57: 200 rows pass the cap
            with pytest.raises(NotImplementedError,
                               match="at most %d" % cap):
                riccati_launch_config(d, P, B)
        else:
            _fits(d, P, B)


def _fits(d, P, B):
    cfg = riccati_launch_config(d, P, B)
    g, lanes = cfg["group"], cfg["lanes_per_block"]
    assert g >= 2 * d and g & (g - 1) == 0
    assert cfg["stages"] in (1, 2)
    assert cfg["smem_bytes"] <= _SMEM
    # one stage of F_t (2 d P entries), U_t and l_t for each lane at least
    stage = 4 * cfg["stages"] * lanes * (2 * d * P + 3 * d)
    if d <= NARROW_MAX_DOF:
        assert cfg["route"] == "registers"
        assert 32 % g == 0 and g * lanes % 32 == 0     # whole compute warps
        assert cfg["threads"] == g * lanes + 32 <= 160  # and a producer warp
        assert cfg["smem_bytes"] >= stage
    else:
        assert cfg["route"] == "shared" and g in (32, 64, 128)
        assert cfg["threads"] == g * lanes + 32 <= 544
        assert g == max(32, 1 << (2 * d - 1).bit_length())
        assert cfg["smem_bytes"] >= stage + 4 * lanes * _lane_floats(d)
    assert cfg["grid"] * lanes >= B > (cfg["grid"] - 1) * lanes


@pytest.mark.parametrize("d", _DOFS)
def test_riccati_launch_config_raises_above_the_cap(d):
    cap = riccati_p_cap(d)
    # 1184 (d = 1) to 2624 (d = 5) rows: far above the iLQR path's 27-34;
    # past eight joints at least the 385 rows of five Pandas to d = 35
    # (640 there), and 144 at d = 64
    assert cap >= (1024 if d <= NARROW_MAX_DOF else 385 if d <= 35 else 144)
    with pytest.raises(NotImplementedError, match="at most %d rows" % cap):
        riccati_launch_config(d, cap + 1, 512)
    # one lane and one stage at the cap fit a block
    cfg = riccati_launch_config(d, cap, 1)
    assert cfg["smem_bytes"] <= _SMEM and cfg["stages"] == 1


def test_riccati_launch_config_reaches_every_sm_and_shrinks_for_large_p():
    """At the iLQR path's shapes the grid covers the H100's 132 SMs; a P
    whose two stages do not fit four lanes takes fewer lanes per block."""
    cfg = riccati_launch_config(7, 27, 512)
    assert cfg["grid"] >= 128 and cfg["stages"] == 2
    big = riccati_launch_config(7, 600, 512)
    assert big["lanes_per_block"] < cfg["lanes_per_block"]
    # the TIAGo (d = 14, P = 76) at B = 512: a warp a lane, four lanes a
    # block, two stages; five Pandas (d = 35, P = 385) at B = 256: one
    # lane and one stage a block (~161 KB)
    tiago = riccati_launch_config(14, 76, 512)
    assert (tiago["route"], tiago["group"], tiago["lanes_per_block"],
            tiago["stages"], tiago["grid"]) == ("shared", 32, 4, 2, 128)
    five = riccati_launch_config(35, 385, 256)
    assert (five["group"], five["lanes_per_block"], five["stages"],
            five["grid"]) == (128, 1, 1, 256)


@pytest.mark.parametrize("d, over_cap", [(7, True), (MAX_DOF + 1, False),
                                         (14, True), (35, True)])
def test_riccati_wrapper_raises_before_any_launch(monkeypatch, d, over_cap):
    """On the card (here: the wrapper's device check made to say so), a P
    above the cap or a d above MAX_DOF raises NotImplementedError before
    either route's kernel is touched."""
    from torch_robotics_tpu_torch.ops import riccati_kernel as rk

    class NoLaunch:
        def launch(self, *args):
            raise AssertionError("the kernel was launched")

    monkeypatch.setattr(rk, "_check", lambda *args: True)
    monkeypatch.setattr(rk, "RICCATI_KERNEL", NoLaunch())
    monkeypatch.setattr(rk, "RICCATI_WIDE_KERNEL", NoLaunch())
    T, B = 2, 4
    P = riccati_p_cap(d) + 1 if over_cap else 27
    sweep = rk.riccati_backward_kernel_factory(d, 2 * d, P, T, 0.04, 1e-4,
                                               1e-6, 1e4)
    ins = (torch.zeros((T, d, B)), torch.zeros((T, 2 * d, B)),
           torch.zeros((T, 2 * d, P, B)), torch.zeros((2 * d, B)))
    with pytest.raises(NotImplementedError):
        sweep(*ins)


def _rollout_expect(d, A, g):
    """The block of one lane past 1024 threads: the rollout raises."""
    return -(-A * g // 32) * 32 > 1024


@pytest.mark.parametrize("A", [1, 5, 12, 40])
@pytest.mark.parametrize("d", _DOFS)
def test_rollout_launch_config_fits_the_card(d, A):
    """A group of the power of two >= d threads a (lane, step size), whole
    warps, lanes a block that divide B (a row of them is one 4, 8 or
    16-byte copy), a ring of a step's Ks, U, ks and xs rows (2 d^2 + 4 d
    floats a lane; 8 slots on the register route, 2 to 8 on the shared
    route beside each group's dx) within a block's shared memory, a grid
    covering B; many step sizes take fewer lanes a block (A = 40 at d = 8:
    4 lanes would take 1280 threads), and past 1024 threads for one lane
    (A = 40 past 16 joints) the config raises."""
    g = 1 << (d - 1).bit_length()
    for B in _BATCHES:
        if _rollout_expect(d, A, g):
            with pytest.raises(NotImplementedError, match="threads"):
                rollout_launch_config(d, A, B)
        else:
            _rollout_fits(d, A, B, g)


def _rollout_fits(d, A, B, g):
    cfg = rollout_launch_config(d, A, B)
    lanes = cfg["lanes_per_block"]
    assert cfg["group"] == g and (d == 1 or g < 2 * d)
    assert lanes in (1, 2, 4) and B % lanes == 0
    assert cfg["threads"] % 32 == 0
    assert cfg["threads"] - 32 < lanes * A * g <= cfg["threads"] <= 1024
    rows = 4 * (2 * d * d + 4 * d) * lanes
    if d <= NARROW_MAX_DOF:
        assert cfg["route"] == "registers" and cfg["stages"] == 8
        assert cfg["smem_bytes"] == 8 * rows
    else:
        assert cfg["route"] == "shared" and 2 <= cfg["stages"] <= 8
        assert cfg["smem_bytes"] == (cfg["stages"] * rows
                                     + 4 * lanes * A * 2 * d)
        deeper = cfg["smem_bytes"] + rows
        assert cfg["stages"] == 8 or deeper > _SMEM
    assert cfg["smem_bytes"] <= _SMEM
    assert cfg["grid"] * lanes == B
    wider = {1: 2, 2: 4}.get(lanes)
    if wider and B % wider == 0:          # the next width does not fit
        threads = -(-wider * A * g // 32) * 32
        stages = ((_SMEM // 4 - wider * A * 2 * d)
                  // ((2 * d * d + 4 * d) * wider))
        assert threads > 1024 or (d > NARROW_MAX_DOF and stages < 2)


@pytest.mark.parametrize("d", _DOFS)
def test_rollout_launch_config_takes_the_widest_copy(d):
    """At the iLQR path's and the tracking loop's B = 512 with its 5 step
    sizes, 4 lanes a block (one 16-byte copy a row; faster than 2 lanes at
    T = 31 and T = 15 in turns on the H100, PERF.md) up to 32 joints, 2
    past them (4 lanes of 64-thread groups would take 1280 threads); the
    most of 4, 2 and 1 that divides B and the inputs' alignment allows."""
    most = 4 if d <= 32 else 2
    assert rollout_launch_config(d, 5, 512)["lanes_per_block"] == most
    assert rollout_launch_config(d, 5, 4096)["lanes_per_block"] == most
    assert rollout_launch_config(d, 5, 100)["lanes_per_block"] == most
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
    with pytest.raises(NotImplementedError, match="threads"):
        rollout_launch_config(64, 17, 512)                  # 1088 threads
    with pytest.raises(NotImplementedError, match="joints"):
        rollout_launch_config(MAX_DOF + 1, 5, 512)
    for lanes, B, align in ((3, 512, 4), (4, 514, 4), (4, 512, 2)):
        with pytest.raises(ValueError, match="lanes"):
            rollout_launch_config(7, 5, B, lanes=lanes, align=align)


@pytest.mark.parametrize("d, A", [(MAX_DOF + 1, 5), (8, 129), (64, 17)])
def test_rollout_wrapper_raises_before_any_launch(monkeypatch, d, A):
    """On the card (here: the wrapper's device check made to say so), a d
    above MAX_DOF or a block of one lane past 1024 threads raises
    NotImplementedError before either route's kernel is touched."""
    from torch_robotics_tpu_torch.ops import riccati_kernel as rk

    class NoLaunch:
        def launch(self, *args):
            raise AssertionError("the kernel was launched")

    monkeypatch.setattr(rk, "_check", lambda *args: True)
    monkeypatch.setattr(rk, "ROLLOUT_KERNEL", NoLaunch())
    monkeypatch.setattr(rk, "ROLLOUT_WIDE_KERNEL", NoLaunch())
    T, B, m = 3, 512, 2 * d
    roll = rk.linesearch_rollout_kernel_factory(
        d, m, T, 0.04, tuple(0.9 ** k for k in range(A)))
    ins = (torch.zeros((T + 1, m, B)), torch.zeros((T, d, B)),
           torch.zeros((T, d, B)), torch.zeros((T, d, m, B)))
    with pytest.raises(NotImplementedError):
        roll(*ins)


@pytest.mark.parametrize("d", [1, 7, 8, 9, 14, 16, 17, 32, 33, 64])
def test_route_and_group_follow_from_d(d):
    """Both launch shapes take their route and group width from d alone:
    registers to NARROW_MAX_DOF joints, shared memory past them, a sweep
    group of the power of two >= 2 d (at least a warp on the shared
    route) and a rollout group of the power of two >= d, whatever P, A
    and B are."""
    route = "registers" if d <= NARROW_MAX_DOF else "shared"
    sweep_g = 1 << (2 * d - 1).bit_length()
    if route == "shared":
        sweep_g = max(32, sweep_g)
    roll_g = 1 << (d - 1).bit_length()
    for B in (1, 100, 512):
        for P in (1, 27):
            cfg = riccati_launch_config(d, P, B)
            assert (cfg["route"], cfg["group"]) == (route, sweep_g)
            assert cfg["threads"] == cfg["lanes_per_block"] * sweep_g + 32
        for A in (1, 5):
            cfg = rollout_launch_config(d, A, B)
            assert (cfg["route"], cfg["group"]) == (route, roll_g)
