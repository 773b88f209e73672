"""The learned self-collision row's tensor-core route (``net_row.cu``'s
``net_terms_tc_kernel`` and ``net_cost_tc_kernel``, 3xTF32) on the CPU: a
numpy model of their arithmetic on the tf32x3 packed buffers, held to the
plain row and to JAX's vjp of the same net, and their packed layout.

The model emulates ``cvt.rna.tf32.f32`` (round to nearest, ties away from
zero, on the 13 low mantissa bits), the split a = a_hi + a_lo, and each
m16n8k8 product as D = fl32(C + sum of 8 exact products) in the kernel's
order: per k-tile of 8, a_lo b_hi, then a_hi b_lo, then a_hi b_hi, k-tiles
ascending (the terms kernel's in groups of 4 from a fresh accumulator).
The tensor cores truncate as they accumulate, so every hold also runs
with a truncating accumulator (acc_trunc): each block of 4 products and C
aligned to their largest exponent, cut toward zero to 24 significand
bits, summed, and the sum cut toward zero to float32.
The output layer and the hinge are FP32 as in the kernel; so are the
terms kernel's layer 1 and its repair of lanes near relu's kink, in the
plain chain's order.

Tolerance: the model's row within 2e-6 of max|plain| (the simt model's
hold in test_torch_net_launch.py): 3xTF32 keeps float32's accuracy to a
few units of 2^-22 per product.  A single TF32 pass, which keeps about
three decimal digits, misses that hold.  Inactive lanes bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_robotics_tpu_torch.costs import SelfCollisionNet
from torch_robotics_tpu_torch.ops.net_kernel import (NetRowParams,
                                                     add_net_cost,
                                                     add_net_terms,
                                                     net_launch_config,
                                                     net_rows,
                                                     pack_net_params)

from test_torch_self_collision_net import (NPZ, box_q, jax_net, numpy_net,
                                           spread)

F32 = np.float32
BUNDLED = (7, 256, 128, 64, 1)
CUTOFF = 0.001
N_RAGGED = 250            # 15 whole tiles of 16 lanes and one of 10
TILE = 16                 # lanes a warp's tile (the terms kernel's)
ATOL_REL = 2e-6


def tf32(x):
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, to nearest,
    ties away from zero (the 13 low bits of the result are 0)."""
    u = np.asarray(x, F32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(x):
    hi = tf32(x)
    return hi, tf32((np.asarray(x, F32) - hi).astype(F32))


TRUNC_BITS = 24           # significand bits the truncating model keeps
TRUNC_BLOCK = 4           # products summed at a time in that model


def acc_trunc(C, P):
    """One block of a truncating tensor-core accumulation: C (M, N) float32
    plus the exact products P (M, k, N): every addend aligned to the
    largest exponent among them and cut toward zero to TRUNC_BITS
    significand bits below it, the cut addends summed exactly, the sum
    cut toward zero to float32."""
    terms = np.concatenate([C[:, None].astype(np.float64), P], axis=1)
    e = np.frexp(terms)[1]
    emax = np.where(terms == 0, -500, e).max(axis=1, keepdims=True)
    ulp = np.ldexp(1.0, np.maximum(emax, -500) - TRUNC_BITS)
    s = (np.trunc(terms / ulp) * ulp).sum(axis=1)
    f = s.astype(F32)
    return np.where(np.abs(f.astype(np.float64)) > np.abs(s),
                    np.nextafter(f, F32(0)), f).astype(F32)


def mma3(A, B, passes=3, group=None, trunc=False):
    """A (M, K) @ B (K, N) as the kernel's chain of m16n8k8 TF32 products
    from a zero accumulator: per k-tile of 8 (ascending), a_lo b_hi, a_hi
    b_lo, a_hi b_hi, each D = fl32(C + its exact 8-term sum), rounded to
    nearest, or with ``trunc`` the truncating model (acc_trunc, blocks of
    TRUNC_BLOCK products).  With ``group`` (the terms kernel's kGroup),
    every ``group`` k-tiles go into a fresh accumulator that is then added
    to the sum in float32 (rounded to nearest, as the CUDA cores add).
    passes=1 is a single TF32 product (a_hi b_hi) for comparison."""
    ah, al = split(A)
    bh, bl = split(B)
    terms = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    n_k = A.shape[1] // 8
    group = group or n_k
    out = np.zeros((A.shape[0], B.shape[1]), F32)
    for g0 in range(0, n_k, group):
        acc = np.zeros_like(out)
        for k0 in range(8 * g0, 8 * min(g0 + group, n_k), 8):
            for a, b in terms:
                if not trunc:
                    k = slice(k0, k0 + 8)
                    acc = (acc.astype(np.float64) + a[:, k].astype(
                        np.float64) @ b[k].astype(np.float64)).astype(F32)
                    continue
                for j in range(k0, k0 + 8, TRUNC_BLOCK):
                    k = slice(j, j + TRUNC_BLOCK)
                    acc = acc_trunc(acc, a[:, k, None].astype(np.float64)
                                    * b[None, k].astype(np.float64))
        out = acc if g0 == 0 else (out + acc).astype(F32)
    return out


def seq_mm(A, B):
    """A (M, K) @ B (K, N) in float32 as the plain chain computes it on the
    card (cuBLAS): each output a sequential FMA over k ascending from 0
    (products exact in float64, one rounding a step)."""
    acc = np.zeros((A.shape[0], B.shape[1]), F32)
    A64, B64 = A.astype(np.float64), B.astype(np.float64)
    for k in range(A.shape[1]):
        acc = (acc + A64[:, k:k + 1] * B64[k:k + 1]).astype(F32)
    return acc


def unpack_tc(ints, floats):
    """The tf32x3 buffers -> (act, d, scale, shift, cutoff, mean (8), std
    (8), [(W (in, out), b)] per hidden layer, w_last (H3,), b_last, [the
    column norms of each hidden W but the first])."""
    L, act, d, route = (int(v) for v in ints[:4])
    assert route == 1
    widths = [int(v) for v in ints[4:4 + L + 1]]
    scale, shift, cutoff = floats[0], floats[1], floats[2]
    mean, std = floats[4:12], floats[12:20]
    off, layers = 20, []
    for n_in, n_out in zip(widths[:-2], widths[1:-1]):
        stride = n_in + (8 - n_in) % 16
        Wt = floats[off:off + n_out * stride].reshape(n_out, stride)
        off += n_out * stride
        layers.append((np.ascontiguousarray(Wt[:, :n_in].T),
                       floats[off:off + n_out]))
        off += n_out
    w_last = floats[off:off + widths[-2]]
    b_last = floats[off + widths[-2]]
    off += widths[-2] + 4
    norms = []
    for w in widths[2:-1]:
        norms.append(floats[off:off + w])
        off += w
    assert off == floats.size
    return act, d, scale, shift, cutoff, mean, std, layers, w_last, b_last, \
        norms


REPAIR_BOUND = 2.0 ** -17     # net_row.cu near_kink's kBound
GROUP = 4                     # net_row.cu kGroup (the terms kernel)


def model_net_row_tc(ints, floats, q, g, H, cost, terms=True, passes=3,
                     trunc=False, group=GROUP):
    """The tf32x3 kernels' arithmetic on their packed buffers, float32
    numpy, tile by tile of 16 lanes (lanes past N are zeros); adds in place
    into g (d, N), H (d, d, N) and cost (N) for active lanes only.

    Cost (net_cost_tc_kernel): every hidden layer a chain of 3xTF32
    products, the FP32 output layer as a warp sums it (four partial fmaf
    chains, then pairwise), the hinge.  Terms (net_terms_tc_kernel): layer
    1 in the plain order (seq_mm), layers 2 and 3 3xTF32, every product
    of the terms kernel summed ``group`` k-tiles at a time; for relu, an
    active lane with a unit of layer 3 whose pre-activation lies within
    REPAIR_BOUND |input row| |unit's weights| of 0 gets its h2 and h3 from
    seq_mm, else each such unit of layer 2 its h2 (the hinge keeps the
    tensor-core r); then on tiles with an active lane the backward chain
    (delta3 = w * act'(h3), delta_l =
    (delta_{l+1} W^T) * act'(h_l), gx = delta1 W0^T), 3xTF32."""
    (act, d, scale, shift, cutoff, mean, std, layers, w_last, b_last,
     norms) = unpack_tc(ints, floats)
    f = (lambda v: np.maximum(v, F32(0))) if act == 0 else np.tanh
    df = (lambda h: (h > 0).astype(F32)) if act == 0 else (
        lambda h: (F32(1) - h * h).astype(F32))
    N = q.shape[1]
    for t0 in range(0, N, TILE):
        n = np.arange(t0, min(t0 + TILE, N))
        x = np.zeros((TILE, 8), F32)
        x[:len(n), :d] = ((q[:, n] - mean[:d, None]) / std[:d, None]).T
        hs, pres = [x], []
        for li, (W, b) in enumerate(layers):
            prod = seq_mm(hs[-1], W) if terms and li == 0 else mma3(
                hs[-1], W, passes, group if terms else None, trunc)
            pres.append((prod + b).astype(F32))
            hs.append(f(pres[-1]).astype(F32))
        # four threads' partial sums over columns 2t, 2t + 1 of each tile
        h3 = hs[-1]
        part = np.zeros((TILE, 4), F32)
        for c0 in range(0, h3.shape[1], 8):
            for t in range(4):
                for c in (c0 + 2 * t, c0 + 2 * t + 1):
                    part[:, t] = (part[:, t].astype(np.float64) + np.float64(
                        w_last[c]) * h3[:, c]).astype(F32)
        s = ((part[:, 0] + part[:, 1]) + (part[:, 2] + part[:, 3])).astype(F32)
        sd = -(((s + b_last) * scale).astype(F32) + shift).astype(F32)
        r = np.maximum(cutoff - sd, F32(0)).astype(F32)[:len(n)]
        on = r > 0
        if not terms:
            cost[n[on]] += F32(0.5) * (r[on] * r[on])
            continue
        if not on.any():
            continue
        if act == 0:
            near = [np.abs(pres[li]) < REPAIR_BOUND * np.linalg.norm(
                hs[li].astype(np.float64), axis=1)[:, None] * norms[li - 1]
                for li in (1, 2)]
            whole = np.nonzero(near[1].any(1)[:len(n)] & on)[0]
            if len(whole):
                h2 = f(seq_mm(hs[1][whole], layers[1][0]) + layers[1][1])
                hs[2][whole] = h2
                hs[3][whole] = f(seq_mm(h2.astype(F32), layers[2][0])
                                 + layers[2][1])
            for lane in np.nonzero(near[0].any(1)[:len(n)] & on)[0]:
                if lane in whole:
                    continue
                u = np.nonzero(near[0][lane])[0]
                hs[2][lane, u] = f(seq_mm(hs[1][lane:lane + 1],
                                          layers[1][0][:, u])[0]
                                   + layers[1][1][u])
        delta = (w_last * df(hs[-1])).astype(F32)
        for i in range(len(layers) - 1, 0, -1):
            delta = (mma3(delta, np.ascontiguousarray(layers[i][0].T),
                          passes, group, trunc) * df(hs[i])).astype(F32)
        gx = mma3(delta, np.ascontiguousarray(layers[0][0].T), passes, group,
                  trunc)
        gq = ((-scale * gx[:len(n), :d]) / std[:d]).astype(F32).T
        Jr = -gq[:, on]
        g[:, n[on]] += r[on] * Jr
        H[:, :, n[on]] += Jr[:, None] * Jr[None]
        cost[n[on]] += F32(0.5) * (r[on] * r[on])


def spread_nets(n, q_seed, w_seed):
    """{"relu" / "tanh": (port net, its arrays)}: spread nets of the
    bundled widths with weight seed w_seed, active on about half of q =
    box_q(n, q_seed); and q (7, n)."""
    q = box_q(n, seed=q_seed)
    out = {}
    with np.load(NPZ) as data:
        for act in ("relu", "tanh"):
            arrays = spread(numpy_net(list(BUNDLED), act, seed=w_seed,
                                      like=data), q)
            out[act] = (SelfCollisionNet.from_arrays(arrays, "cpu"), arrays)
    return out, np.ascontiguousarray(q.T)


# the nets and q of the model's holds, and another sample (neither the one
# the repair bound was set on) for its margin
SAMPLES = {"ragged": (N_RAGGED, 6, 41), "other": (512, 11, 43)}


@pytest.fixture(scope="module")
def nets():
    """{kind: (port net, its arrays)}: the bundled net and relu / tanh
    spread nets of the bundled widths, active on about half of q; and q
    (7, N_RAGGED)."""
    by_act, qc = spread_nets(*SAMPLES["ragged"])
    net = SelfCollisionNet.from_npz(NPZ, device="cpu")
    out = {"bundled": (net, net.arrays())}
    out.update({act + "_spread": v for act, v in by_act.items()})
    return out, qc


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),       # 1.0 is exact
    (0x3F800FFF, 0x3F800000),       # below half an ulp: down
    (0x3F801000, 0x3F802000),       # a tie: away from zero
    (0xBF801000, 0xBF802000),       # a negative tie: away from zero
    (0x3F803000, 0x3F804000),       # a tie on an odd ulp: up as well
    (0x3F801001, 0x3F802000),       # above half: up
    (0x3FFFF000, 0x40000000),       # the carry reaches the exponent
])
def test_tf32_rounds_to_nearest_ties_away(bits, want):
    x = np.asarray([bits], np.uint32).view(F32)
    assert tf32(x).view(np.uint32)[0] == want


@pytest.mark.parametrize("trunc", [False, True], ids=["rn", "trunc"])
@pytest.mark.parametrize("kind", ["bundled", "relu_spread", "tanh_spread"])
def test_tc_model_matches_plain_and_jax(nets, kind, trunc):
    """At a ragged N (the last tile 10 of 16 lanes): the model of the
    tensor-core kernel, with a rounding or a truncating accumulator, adds
    the plain row's contribution to within ATOL_REL of max|ref| and leaves
    every inactive lane's g, H and cost bit for bit; the plain row's r and
    Jr equal JAX's vjp of the same net."""
    by_kind, qc = nets
    net, arrays = by_kind[kind]
    N = qc.shape[1]
    rng = np.random.default_rng(7)
    g0 = rng.normal(size=(7, N)).astype(F32)
    H0 = rng.normal(size=(7, 7, N)).astype(F32)
    c0 = np.abs(rng.normal(size=N)).astype(F32)
    ints, floats = pack_net_params(net, CUTOFF)
    assert net_launch_config(net.widths, net.activation)["route"] == "tf32x3"
    g, H, c, c2 = g0.copy(), H0.copy(), c0.copy(), c0.copy()
    model_net_row_tc(ints, floats, qc, g, H, c, trunc=trunc)
    model_net_row_tc(ints, floats, qc, None, None, c2, terms=False,
                     trunc=trunc)
    ref = [torch.as_tensor(a.copy()) for a in (g0, H0, c0)]
    row = NetRowParams(net, CUTOFF, "cpu")
    add_net_terms(row, torch.as_tensor(qc), *ref)
    cost_ref = torch.as_tensor(c0.copy())
    add_net_cost(row, torch.as_tensor(qc), cost_ref)
    for got, r in ((g, ref[0]), (H, ref[1]), (c, ref[2]), (c2, cost_ref)):
        r = r.numpy()
        np.testing.assert_allclose(got, r, rtol=0,
                                   atol=ATOL_REL * np.abs(r).max())
    r_row, J_row = (t.numpy() for t in net_rows(net, torch.as_tensor(qc),
                                                 CUTOFF))
    off = r_row == 0
    assert np.array_equal(g[:, off], g0[:, off])
    assert np.array_equal(H[..., off], H0[..., off])
    assert np.array_equal(c[off], c0[off])
    assert np.array_equal(c2[off], c0[off])
    if kind == "bundled":
        assert off.all()
        return
    assert 0.25 <= 1 - off.mean() <= 0.75
    sd_jax, vjp = jax.vjp(jax_net(arrays).signed_distance,
                          jnp.asarray(qc.T))
    r_jax = np.asarray(jax.nn.relu(CUTOFF - sd_jax))
    np.testing.assert_allclose(r_row, r_jax, rtol=1e-5, atol=1e-6)
    J_jax = -(r_jax > 0).astype(F32)[None] * np.asarray(
        vjp(jnp.ones(N))[0]).T
    np.testing.assert_allclose(J_row, J_jax, rtol=1e-5,
                               atol=1e-6 * np.abs(J_jax).max())


def row_err(net, qc, terms=True, **model):
    """The model's row (terms: g, H and cost; else the cost) from zeros, off
    the plain row: the largest gap over max|ref|, per output, maximised."""
    ints, floats = pack_net_params(net, CUTOFF)
    N = qc.shape[1]
    row = NetRowParams(net, CUTOFF, "cpu")
    if terms:
        ref = [torch.zeros(7, N), torch.zeros(7, 7, N), torch.zeros(N)]
        add_net_terms(row, torch.as_tensor(qc), *ref)
        got = [np.zeros((7, N), F32), np.zeros((7, 7, N), F32),
               np.zeros(N, F32)]
    else:
        ref = [torch.zeros(N)]
        add_net_cost(row, torch.as_tensor(qc), ref[0])
        got = [None, None, np.zeros(N, F32)]
    model_net_row_tc(ints, floats, qc, *got, terms=terms, **model)
    return max(np.abs(a - r.numpy()).max() / np.abs(r.numpy()).max()
               for a, r in zip(got[-len(ref):], ref))


@pytest.mark.parametrize("kind", ["relu_spread", "tanh_spread"])
def test_single_tf32_pass_misses_the_hold(nets, kind):
    """The hold has teeth: one TF32 pass (a_hi b_hi only) is off the plain
    row by more than ATOL_REL of max|ref|, the three passes are not."""
    net, _ = nets[0][kind]
    errs = {p: row_err(net, nets[1], passes=p) for p in (1, 3)}
    assert errs[3] <= ATOL_REL < errs[1]


@pytest.mark.parametrize("kind", ["relu_spread", "tanh_spread"])
def test_truncation_needs_the_groups(nets, kind):
    """Why the terms kernel sums GROUP k-tiles into a fresh accumulator:
    with a truncating accumulator, one chain a product drifts off the
    plain row by more than ATOL_REL of max|ref|, the groups do not.  (The
    value-only row keeps one chain: test_tc_model_matches_plain_and_jax
    holds its cost at ATOL_REL under truncation.)"""
    net, _ = nets[0][kind]
    errs = {g: row_err(net, nets[1], trunc=True, group=g)
            for g in (None, GROUP)}
    assert errs[GROUP] <= ATOL_REL < errs[None]


def test_tc_packed_layout(nets):
    """ints [L, act, d, route 1, 8, hidden..., 1]; floats [scale, shift,
    cutoff, 0, mean (8), std (8)], then each hidden layer's W^T (out, in)
    with rows of 8, 264 and 136 floats (zero padding) and its b, then the
    last layer's column, its bias padded to 4, and the column norms of W1
    and W2: 45,272 floats."""
    net, a = nets[0]["tanh_spread"]
    ints, floats = pack_net_params(net, CUTOFF)
    assert ints.dtype == np.int32 and floats.dtype == np.float32
    assert ints.tolist() == [4, 1, 7, 1, 8, 256, 128, 64, 1]
    assert floats.size == 20 + 256 * 8 + 256 + 128 * 264 + 128 \
        + 64 * 136 + 64 + 64 + 4 + 128 + 64 == 45272
    assert floats[:4].tolist() == [F32(a["scale_out"][0]),
                                   F32(a["scale_out"][1]), F32(CUTOFF), 0]
    assert floats[11] == 0 and floats[19] == 1       # mean / std padding
    W0t = floats[20:20 + 256 * 8].reshape(256, 8)
    assert np.array_equal(W0t[:, :7], a["W0"].T) and not W0t[:, 7].any()
    off = 20 + 256 * 8 + 256
    W1t = floats[off:off + 128 * 264].reshape(128, 264)
    assert np.array_equal(W1t[:, :256], a["W1"].T)
    assert not W1t[:, 256:].any()
    unpacked = unpack_tc(ints, floats)
    for (W, b), i in zip(unpacked[7], range(3)):
        assert np.array_equal(W[:a["W%d" % i].shape[0]], a["W%d" % i])
        assert np.array_equal(b, a["b%d" % i])
    assert np.array_equal(unpacked[8], a["W3"][:, 0])
    assert unpacked[9] == a["b3"][0]
    for norms, i in zip(unpacked[10], (1, 2)):
        np.testing.assert_allclose(norms, np.linalg.norm(a["W%d" % i], axis=0),
                                   rtol=1e-6)


def repair_gap(net, qc, trunc):
    """The largest distance between the 3xTF32 sum (the terms kernel's
    groups) and the sequential FP32 sum (the plain chain's order) of a
    layer-2 or layer-3 pre-activation, over |a| |w_unit|."""
    ints, floats = pack_net_params(net, CUTOFF)
    act, d, _, _, _, mean, std, layers, _, _, norms = unpack_tc(ints, floats)
    f = (lambda v: np.maximum(v, F32(0))) if act == 0 else np.tanh
    x = np.zeros((qc.shape[1], 8), F32)
    x[:, :d] = ((qc - mean[:d, None]) / std[:d, None]).T
    h = f(seq_mm(x, layers[0][0]) + layers[0][1]).astype(F32)
    worst = 0.0
    for (W, b), wn in zip(layers[1:], norms):
        pre_tc = (mma3(h, W, group=GROUP, trunc=trunc) + b).astype(F32)
        pre_seq = (seq_mm(h, W) + b).astype(F32)
        scale = np.linalg.norm(h.astype(np.float64), axis=1)[:, None] * wn
        worst = max(worst, float((np.abs(pre_tc.astype(np.float64)
                                         - pre_seq) / scale).max()))
        h = f(pre_tc).astype(F32)
    return worst


@pytest.mark.parametrize("trunc", [False, True], ids=["rn", "trunc"])
@pytest.mark.parametrize("sample", sorted(SAMPLES))
def test_repair_bound_covers_the_sums(sample, trunc):
    """On the relu and tanh spread nets' layer-2 and layer-3 pre-activations
    (192 units each; N_RAGGED lanes, or the other sample's nets and 512
    lanes), with a rounding or a truncating accumulator: the 3xTF32 sum
    and the sequential FP32 sum lie within REPAIR_BOUND / 8 |a| |w_unit|
    of each other, so a unit outside the bound has the same relu' decision
    in both."""
    by_act, qc = spread_nets(*SAMPLES[sample])
    for act, (net, _) in by_act.items():
        worst = repair_gap(net, qc, trunc)
        assert 0 < worst < REPAIR_BOUND / 8, (act, worst)


if __name__ == "__main__":
    # the truncating model's row errors (over max|ref|): the terms row with
    # one chain a product and with the kernel's groups, the value-only row
    by_act, qc = spread_nets(*SAMPLES["ragged"])
    for act, (net, _) in by_act.items():
        print(act, "trunc terms one chain", row_err(net, qc, trunc=True,
                                                    group=None),
              "groups", row_err(net, qc, trunc=True),
              "cost", row_err(net, qc, terms=False, trunc=True))
    # the repair bound's margin: REPAIR_BOUND over the largest gap
    for sample in sorted(SAMPLES):
        by_act, qc = spread_nets(*SAMPLES[sample])
        for trunc in (False, True):
            for act, (net, _) in by_act.items():
                print(sample, "trunc" if trunc else "rn", act,
                      REPAIR_BOUND / repair_gap(net, qc, trunc))
