"""The host side of the tensor-core row products: weights split into TF32 hi and lo parts and
laid out as mma.sync B fragments (``ops/kernels/_mma.py``), for every wrapper that feeds
one (B6, B8's tail, B9's projection, B10, B14), and the persistent row product's grid. CPU
only: the layout and the split are plain tensor code, and what the kernel reads of them is
checked here against numpy."""

import numpy as np
import pytest
import torch

from freqfusion_tpu_torch.ops.kernels import _mma, sgfn, wattn


_TF32_MASK = -0x2000   # 0xffffe000 as an int32


def _unpack(packed):
    """The padded (hi, lo) [kp,npad] that ``_mma.mma_planes`` laid out, lo's top 19 bits
    only, as the MMA reads it: the layout's inverse, written out on its own here."""
    ks, nt = packed.shape[:2]

    def plane(t):  # [ks, nt, 32 = 4 g + t, 2 = rows t, t + 4] -> [kp, npad]
        return t.reshape(ks, nt, 8, 4, 2).permute(0, 4, 3, 1, 2).reshape(8 * ks, 8 * nt)

    lo = (packed[..., 2:].contiguous().view(torch.int32) & _TF32_MASK).view(torch.float32)
    return plane(packed[..., :2]), plane(lo)


def _r(rng, *shape, std=1.0):
    return torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32))


def _tf32_nearest(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero, by
    comparing the two neighbours in float64: an independent check of the bit trick."""
    bits = x.view(np.uint32)
    down = (bits & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)
    up = ((bits & np.uint32(0xFFFFE000)) + np.uint32(0x2000)).view(np.float32).astype(np.float64)
    xd = x.astype(np.float64)
    d_down, d_up = np.abs(xd - down), np.abs(up - xd)
    return np.where(d_up <= d_down, up, down).astype(np.float32)   # a tie goes up: away


def test_split_tf32_rounds_to_nearest_and_keeps_the_sum():
    rng = np.random.default_rng(0)
    x = np.concatenate([(rng.standard_normal(4000) * 10.0 ** rng.integers(-6, 6, 4000)).astype(
        np.float32), np.float32([0.0, -0.0, 1.0, -1.0, 3.0e-39, -2.5e-38])])
    # exact ties: the low 13 bits are half a TF32 ulp
    ties = ((rng.integers(0x3F800000, 0x40800000, 64).astype(np.uint32) & np.uint32(0xFFFFE000))
            | np.uint32(0x1000)).view(np.float32)
    x = np.concatenate([x, ties, -ties])
    hi, lo = _mma.split_tf32(torch.from_numpy(x))
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi + lo, torch.from_numpy(x))   # bit for bit
    np.testing.assert_array_equal(hi.numpy(), _tf32_nearest(x))
    t = torch.from_numpy(ties)
    assert (_mma.split_tf32(t)[0] > t).all() and (_mma.split_tf32(-t)[0] < -t).all()


def test_mma_planes_lay_out_the_b_fragments():
    """Lane 4 g + t of k-step s and n-tile j holds (hi[t][g], hi[t+4][g], lo[t][g],
    lo[t+4][g]) of that 8 x 8 tile; lo carries the half ulp the MMA's truncation needs."""
    rng = np.random.default_rng(1)
    w = _r(rng, 24, 40)
    packed = _mma.mma_planes(w)
    assert packed.shape == (3, 5, 32, 4)
    hi, lo = _mma.split_tf32(w)
    for s, j, g, t in ((0, 0, 0, 0), (2, 4, 7, 3), (1, 2, 5, 1)):
        lane = packed[s, j, 4 * g + t]
        r, n = 8 * s + t, 8 * j + g
        assert lane[0] == hi[r, n] and lane[1] == hi[r + 4, n]
        for e, rr in ((2, r), (3, r + 4)):
            assert lane[e:e + 1].view(torch.int32) == lo[rr:rr + 1, n].view(torch.int32) + 0x1000
    uhi, ulo = _unpack(packed)
    assert torch.equal(uhi, hi)
    assert (ulo - lo).abs().max() <= 2.0 ** -11 * lo.abs().max()
    with pytest.raises(ValueError, match="multiples of 8"):
        _mma.mma_planes(w[:20])


def _assert_keeps_product(packed, w, rng):
    """x @ (hi + lo), lo as the MMA reads it, against x @ w in float64: within 1e-6 of the
    sum of |x| |w| (3xTF32 drops the lo*lo term, about 2^-22 of each product)."""
    k, n = w.shape
    hi, lo = _unpack(packed)
    assert not hi[k:].any() and not hi[:, n:].any() and not lo[k:].any() and not lo[:, n:].any()
    x = _r(rng, 7, hi.shape[0]).double()
    x[:, k:] = 0.0
    got = (x @ (hi.double() + lo.double()))[:, :n]
    want = x[:, :k] @ w.double()
    scale = x[:, :k].abs() @ w.double().abs()
    assert ((got - want).abs() <= 1e-6 * scale).all()


@pytest.mark.parametrize("c,hid", [(180, 720), (64, 128), (20, 40)])
def test_sgfn_weight_planes_keep_the_products(c, hid):
    rng = np.random.default_rng(hid)
    w1, w2 = _r(rng, c, hid, std=c ** -0.5), _r(rng, hid // 2, c, std=(hid // 2) ** -0.5)
    kp, k2p, npad = sgfn._widths(c, hid)
    assert (kp, k2p, npad) == (-(-c // 8) * 8, -(-hid // 16) * 8, -(-c // 8) * 8)
    w1p, w2p = _mma.planes(w1, kp, hid), _mma.planes(w2, k2p, npad)
    assert w1p.shape == (kp // 8, hid // 8, 32, 4) and w2p.shape == (k2p // 8, npad // 8, 32, 4)
    _assert_keeps_product(w1p, w1, rng)
    _assert_keeps_product(w2p, w2, rng)


def test_row_product_weight_planes_keep_the_products():
    """B9's projection (the same layout serves B8's tail, B10 and B14)."""
    rng = np.random.default_rng(5)
    c, hid = 180, 360
    wp = _r(rng, c, c, std=c ** -0.5)
    _assert_keeps_product(_mma.planes(wp, 184, 184), wp, rng)
    w1, w2 = _r(rng, c, hid, std=c ** -0.5), _r(rng, hid, c, std=hid ** -0.5)
    kp, k2p, w1p, w2p = wattn._mlp_planes(c, w1, w2)
    assert (kp, k2p) == (184, 360)
    _assert_keeps_product(w1p, w1, rng)
    _assert_keeps_product(w2p, w2, rng)


def test_planes_are_made_once_for_each_weight():
    """A weight's planes are kept beside it: the same tensor for every view of it that the
    models pass (``linear.weight.t()``) until the weight changes in place."""
    lin = torch.nn.Linear(20, 12)
    with torch.no_grad():
        first = _mma.planes(lin.weight.t(), 24, 16)
        assert _mma.planes(lin.weight.t(), 24, 16) is first
        assert _mma.planes(lin.weight.t(), 24, 24) is not first   # another padding
        assert torch.equal(_mma.planes(lin.weight.t(), 24, 24)[:, :2], first)
        lin.weight.mul_(2.0)
        again = _mma.planes(lin.weight.t(), 24, 16)
    assert again is not first
    assert torch.equal(again, _mma.mma_planes(_mma.padded(lin.weight.detach().t(), 24, 16)))


@pytest.mark.parametrize("how", ["load_state_dict", "data", "inference"])
def test_planes_follow_a_weight_that_is_replaced(how):
    """Loading a checkpoint (an in-place copy), swapping the weight's memory as
    ``module.to`` does, or an inference tensor, which counts no versions: the planes are
    those of the weight as it is now."""
    rng = np.random.default_rng(6)
    lin = torch.nn.Linear(16, 8)
    with torch.no_grad():
        _mma.planes(lin.weight.t(), 16, 8)
        new = _r(rng, 8, 16)
        if how == "load_state_dict":
            lin.load_state_dict({"weight": new, "bias": lin.bias.detach().clone()})
        elif how == "data":
            lin.weight.data = new.clone()
    with torch.no_grad():
        if how == "inference":
            with torch.inference_mode():
                w = new.clone()
            got, again = _mma.planes(w.t(), 16, 8), _mma.planes(w.t(), 16, 8)
            assert got is not again
        else:
            got = _mma.planes(lin.weight.t(), 16, 8)
            assert _mma.planes(lin.weight.t(), 16, 8) is got
    assert torch.equal(got, _mma.mma_planes(new.t().contiguous()))


@pytest.mark.parametrize("c,want", [(180, [184]), (256, [128, 128]), (384, [192, 192]),
                                    (420, [144, 144, 136])])
def test_row_products_take_k_in_pieces_of_at_most_192(c, want):
    """The rows of K that the row kernels (B6's fc1, B8's tail, B10) stage at a time: one
    piece up to 192, else the fewest pieces of at most 192, multiples of 8 as even as they
    fall (``tile_mma_piece`` of csrc/mma_f32x3.cuh)."""
    kp = -(-c // 8) * 8
    got = _mma.piece_sizes(kp)
    assert got == want and sum(got) == kp
    assert all(p % 8 == 0 and p <= _mma.MAX_ROW_K for p in got)
    n = -(-kp // _mma.MAX_ROW_K)
    assert len(got) == n and got[0] == ((kp + n - 1) // n + 7) // 8 * 8


@pytest.mark.parametrize("npix,sms,want", [(1, 132, 1), (128, 132, 1), (129, 132, 2),
                                           (16896, 132, 132), (16897, 132, 132),
                                           (180224, 132, 132), (180224, 7, 7), (5, 264, 1)])
def test_row_grid_is_one_block_an_sm_and_at_most_one_a_tile(npix, sms, want):
    """The launch's blocks: the card's SM count, or fewer where the pixels fill fewer row
    tiles (a block never walks nothing)."""
    tiles = _mma.row_tiles(npix)
    assert tiles == -(-npix // 128) and (tiles - 1) * 128 < npix <= tiles * 128
    grid = _mma.row_grid(npix, sms)
    assert grid == want and 1 <= grid <= tiles


def _hand_slab(wqkv, bqkv, heads, hd, kp):
    """The [heads, kp, 96] slabs of the shared attention kernel, written out by hand: head
    h's q, k, v columns of wqkv in the 32-column slots 0, 1, 2, zero elsewhere."""
    cin = wqkv.shape[0]
    wh, bh = torch.zeros(heads, kp, 96), torch.zeros(heads, 96)
    for h in range(heads):
        for sec in range(3):
            cols = slice(sec * heads * hd + h * hd, sec * heads * hd + (h + 1) * hd)
            wh[h, :cin, 32 * sec:32 * sec + hd] = wqkv[:, cols]
            bh[h, 32 * sec:32 * sec + hd] = bqkv[cols]
    return wh, bh


@pytest.mark.parametrize("cin,heads,hd,br", [(180, 3, 30, 0), (180, 3, 30, 1), (64, 4, 8, 1)])
def test_b4_slab_is_the_branch_q_k_v_in_three_slots(cin, heads, hd, br):
    """B4 takes DAT's whole [Cin,3C] projection and a branch's columns: its slabs are that
    branch's q | k | v, three 32-column slots a head (no zero slot, rows Cin.. zero), K
    padded to a multiple of 8."""
    rng = np.random.default_rng(cin + br)
    co = heads * hd
    wqkv, bqkv = _r(rng, cin, 6 * co), _r(rng, 6 * co)
    kp = -(-cin // 8) * 8
    wh, bh = wattn.head_slabs(wqkv, bqkv, heads, hd, kp, (br * co, co))
    c = 2 * co
    sel = torch.cat([torch.arange(s * c + br * co, s * c + br * co + co) for s in range(3)])
    want_w, want_b = _hand_slab(wqkv[:, sel], bqkv[sel], heads, hd, kp)
    assert wh.shape == (heads, kp, 96) and bh.shape == (heads, 96)
    assert torch.equal(wh, want_w) and torch.equal(bh, want_b)
    wb, bb = wattn.branch_qkv(wqkv, bqkv, br * co, co)
    assert torch.equal(wb, wqkv[:, sel]) and torch.equal(bb, bqkv[sel])


def test_head_slabs_are_made_once_for_each_weight_and_branch():
    """The slabs are kept on the module's own parameter (the view ``qkv.weight.t()`` that
    the models pass): a second call hits, another branch or head count does not, and an
    in-place change of the weight or of the bias, or ``module.to``, makes them anew."""
    lin = torch.nn.Linear(24, 72)
    with torch.no_grad():
        def slabs(cols=(0, 12), heads=2):
            return wattn.head_slabs(lin.weight.t(), lin.bias, heads, 12 // heads, 24, cols)

        first = slabs()
        assert slabs() is first
        assert slabs((12, 12)) is not first and slabs(heads=3) is not first
        lin.weight.mul_(2.0)
        after_w = slabs()
        assert after_w is not first and torch.equal(after_w[0], 2 * first[0])
        lin.bias.add_(1.0)
        after_b = slabs()
        assert after_b is not after_w and torch.equal(after_b[1][:, :6], first[1][:, :6] + 1)
        lin.double().float()   # new memory, as module.to() gives
        moved = slabs()
        assert moved is not after_b and torch.equal(moved[0], after_b[0])
        assert slabs() is moved


def test_naf_stage_a_planes_lay_w1_out_pass_by_pass():
    """B1's 1x1 product takes w1 [C,2C] in passes of 32 gate channels and their 32 partners:
    the planes unpack to those columns, keep the product, and are made once for the conv's
    weight (the view NAFBlock passes) until it changes in place."""
    from freqfusion_tpu_torch.ops.kernels import nafblock
    rng = np.random.default_rng(9)
    c = 64
    w1 = _r(rng, c, 2 * c, std=c ** -0.5)
    packed = nafblock.stage_a_planes(w1)
    assert packed.shape == (c // 8, c // 4, 32, 4)
    hi, lo = _unpack(packed)
    order = torch.cat([torch.cat([torch.arange(32 * p, 32 * p + 32),
                                  torch.arange(c + 32 * p, c + 32 * p + 32)])
                       for p in range(c // 32)])
    assert torch.equal(hi, _mma.split_tf32(w1[:, order])[0])
    _assert_keeps_product(packed, w1[:, order], rng)
    conv = torch.nn.Conv2d(c, 2 * c, 1)
    with torch.no_grad():
        view = lambda: conv.weight.reshape(-1, c).t()   # noqa: E731
        first = nafblock.stage_a_planes(view())
        assert nafblock.stage_a_planes(view()) is first
        conv.weight.mul_(0.5)
        assert nafblock.stage_a_planes(view()) is not first


@pytest.mark.parametrize("move", ["double_float", "half_float"])
def test_kept_entries_follow_a_weight_that_moves(move):
    """Moving a module's weights (``double().float()`` keeps the values, ``half().float()``
    changes them) gives each parameter new memory, which the allocator may place at the
    address it has just freed: every move makes the planes anew, equal to those of the new
    values, and the weight keeps one entry for its view however often it moves."""
    rng = np.random.default_rng(10)
    lin = torch.nn.Linear(20, 12)
    with torch.no_grad():
        lin.weight.copy_(_r(rng, 12, 20))
        before = first = _mma.planes(lin.weight.t(), 24, 16)
        for _ in range(4):
            if move == "double_float":
                lin.double().float()
            else:
                lin.half().float()
            got = _mma.planes(lin.weight.t(), 24, 16)
            assert got is not before
            assert torch.equal(got, _mma.mma_planes(_mma.padded(lin.weight.detach().t(), 24, 16)))
            assert _mma.planes(lin.weight.t(), 24, 16) is got
            assert len(_mma._KEPT[lin.weight]) == 1
            before = got
    # half() rounds the values away, and the planes follow them
    assert torch.equal(before, first) == (move == "double_float")


def test_naf_stage_b_planes_interleave_w4s_gate_columns():
    """B2's three products: w3 and w5 as they are, w4 [C,2C] with gate channel j in column
    2j and its partner C+j in 2j+1. The planes unpack to those columns, keep the products,
    and are made once for the views that NAFBlock passes until a weight changes in place."""
    from freqfusion_tpu_torch.models.nafnet import NAFBlock
    from freqfusion_tpu_torch.ops.kernels import nafblock
    rng = np.random.default_rng(11)
    c = 64
    w3, w4, w5 = (_r(rng, c, n, std=c ** -0.5) for n in (c, 2 * c, c))
    p3, p4, p5 = nafblock.stage_b_planes(w3, w4, w5)
    assert p3.shape == p5.shape == (c // 8, c // 8, 32, 4) and p4.shape == (c // 8, c // 4, 32, 4)
    order = torch.stack([torch.arange(c), torch.arange(c, 2 * c)], dim=1).reshape(-1)
    assert order[:4].tolist() == [0, c, 1, c + 1]
    hi, _ = _unpack(p4)
    assert torch.equal(hi, _mma.split_tf32(w4[:, order])[0])
    for packed, w in ((p3, w3), (p4, w4[:, order]), (p5, w5)):
        _assert_keeps_product(packed, w, rng)
    block = NAFBlock(c)
    with torch.no_grad():
        def planes():
            prm = block.fused_params()
            return nafblock.stage_b_planes(prm["w3"], prm["w4"], prm["w5"])

        first = planes()
        again = planes()
        assert all(a is b for a, b in zip(first, again))
        block.conv4.weight.mul_(0.5)
        after = planes()
        assert after[0] is first[0] and after[2] is first[2] and after[1] is not first[1]
        w4_now = block.conv4.weight.detach().reshape(2 * c, c).t()
        assert torch.equal(after[1], _mma.mma_planes(w4_now[:, order].contiguous()))


def test_aim_gates_planes_pad_fc1_and_the_projection():
    """B5b's S-Map fc1 [C,mid] zero-padded to one group [1,C,SMAP_GROUP] (its CUDA-core
    sums) and its projection [C,C] as planes of [Kp,Kp] (DAT: 180 -> 184): the projection
    keeps its product, and both are made once for the views that DAT's AIM passes, and anew
    after an in-place change."""
    import torch.nn.functional as F
    from freqfusion_tpu_torch.models import dat as dat_model
    from freqfusion_tpu_torch.ops.kernels import aim
    rng = np.random.default_rng(12)
    c, mid = 180, 11
    w1, wp = _r(rng, 1, 1, c, mid, std=c ** -0.5), _r(rng, c, c, std=c ** -0.5)
    kp, fc1, projp = aim.gates_planes(w1, wp)
    assert kp == 184 and projp.shape == (23, 23, 32, 4)
    assert torch.equal(fc1, F.pad(w1.reshape(c, mid), (0, aim.SMAP_GROUP - mid))[None])
    _assert_keeps_product(projp, wp, rng)
    m = dat_model._AIM(c)
    with torch.no_grad():
        def planes():
            g = m.gates_weights()
            return aim.gates_planes(g[0], g[6])[1:]

        first = planes()
        assert all(a is b for a, b in zip(first, planes()))
        m.proj.weight.mul_(2.0)
        after = planes()
        assert after[0] is first[0] and after[1] is not first[1]
        assert torch.equal(after[1], _mma.mma_planes(_mma.padded(m.proj.weight.detach().t(),
                                                                 kp, kp)))
        m.spatial_interaction[0].weight.add_(1.0)
        again = planes()
        assert again[0] is not first[0] and again[1] is after[1]
        w_now = m.spatial_interaction[0].weight.detach().reshape(mid, c).t()
        assert torch.equal(again[0], F.pad(w_now, (0, aim.SMAP_GROUP - mid))[None])


@pytest.mark.parametrize("c,mid", [(256, 16), (256, 32), (64, 12)])
def test_aim_smap_groups_take_mid_in_groups_of_12(c, mid):
    """B5b's S-Map above 12 hidden units: fc1 [C,mid] as [ceil(mid/12), C, 12], group g
    holding hidden units 12g .. 12g + 11 and zeros past mid, so that the groups' dot products
    are fc1's."""
    from freqfusion_tpu_torch.ops.kernels import aim
    rng = np.random.default_rng(mid)
    w1 = _r(rng, c, mid, std=c ** -0.5)
    groups = aim.smap_groups(w1)
    ng = -(-mid // aim.SMAP_GROUP)
    assert groups.shape == (ng, c, aim.SMAP_GROUP) and groups.is_contiguous()
    for g in range(ng):
        m0, m1 = g * aim.SMAP_GROUP, min(mid, (g + 1) * aim.SMAP_GROUP)
        assert torch.equal(groups[g, :, :m1 - m0], w1[:, m0:m1])
        assert not groups[g, :, m1 - m0:].any()
    x = _r(rng, 5, c)
    got = torch.cat([x @ groups[g] for g in range(ng)], dim=1)[:, :mid]
    torch.testing.assert_close(got, x @ w1, atol=0, rtol=0)


def _unpack_fragments(frags):
    """[ks, nt, 32 = 4 g + t, 2 = rows t, t + 4] -> the [8 ks, 8 nt] matrix they hold."""
    ks, nt = frags.shape[:2]
    return frags.reshape(ks, nt, 8, 4, 2).permute(0, 4, 3, 1, 2).reshape(8 * ks, 8 * nt)


@pytest.mark.parametrize("d,heads", [(64, 4), (96, 4), (128, 2)])
def test_band_weights_are_unsplit_fragments_made_once_for_each_weight(d, heads):
    """B11's weights, resident in its blocks' shared memory unsplit: wqkv [D,3D] and wproj
    [D,D] as mma.sync's B fragments, [D/8, N/8, 32, 2] with lane 4g + t holding (w[t][g],
    w[t+4][g]) of its 8 x 8 tile, bit for bit; made once for the views that the head's
    TorchMHA passes (``raw``), and anew after an in-place change."""
    from freqfusion_tpu_torch.models.layers import TorchMHA
    from freqfusion_tpu_torch.ops.kernels import bandmha
    torch.manual_seed(d)
    mha = TorchMHA(d, heads)
    with torch.no_grad():
        wqkv, _, wproj, _ = mha.raw()
        assert wqkv._base is mha.in_proj_weight and wproj._base is mha.out_proj.weight
        fq, fp = bandmha.band_weights(wqkv, wproj)
        assert fq.shape == (d // 8, 3 * d // 8, 32, 2) and fp.shape == (d // 8, d // 8, 32, 2)
        assert fq.is_contiguous() and fp.is_contiguous()
        assert torch.equal(_unpack_fragments(fq), wqkv) and torch.equal(_unpack_fragments(fp), wproj)
        lane = fq[1, 2, 4 * 5 + 3]   # k-step 1, n-tile 2, g = 5, t = 3
        assert lane[0] == wqkv[8 + 3, 16 + 5] and lane[1] == wqkv[8 + 7, 16 + 5]
        again = bandmha.band_weights(*mha.raw()[::2])
        assert again[0] is fq and again[1] is fp
        mha.out_proj.weight.mul_(0.5)
        after = bandmha.band_weights(*mha.raw()[::2])
        assert after[0] is fq and after[1] is not fp
        assert torch.equal(_unpack_fragments(after[1]), mha.out_proj.weight.t())


@pytest.mark.parametrize("first", ["f32", "default"])
def test_default_planes_and_f32_planes_are_never_one_cache_entry(first):
    """An f32 weight's planes at bf16 operands (precision "default": hi its bf16 rounding,
    lo zero) and its 3xTF32 planes are kept under keys of their own, in either order of first
    use; each is made once, and the two never stand for each other. The same holds for the
    layouts that wrap ``kept`` themselves (B1's stage-A planes, B2's w4, B5b's projection)."""
    from freqfusion_tpu_torch.ops.kernels import aim, nafblock

    rng = np.random.default_rng(5)
    w = torch.nn.Parameter(_r(rng, 40, 56), requires_grad=False)
    want = {"f32": _mma.mma_planes(_mma.padded(w, 40, 56)),
            "default": _mma.mma_planes(_mma.padded(w.to(torch.bfloat16), 40, 56))}
    order = [first, "default" if first == "f32" else "f32"]
    got = {}
    for mode in order + order:   # the second round must hit the kept entries
        p = _mma.planes(w, 40, 56, mode == "default")
        assert torch.equal(p, want[mode]), mode
        assert got.setdefault(mode, p) is p, mode
    assert not torch.equal(got["f32"], got["default"])
    assert not got["default"][..., 2:].any()
    hi, _ = _unpack(got["default"])
    assert torch.equal(hi[:40, :56], w.to(torch.bfloat16).float())
    w1 = _r(rng, 32, 64)
    for fn in (lambda bf: nafblock.stage_a_planes(w1, bf),
               lambda bf: nafblock.stage_b_planes(w1[:, :32], w1, w1[:, 32:], bf)[1],
               lambda bf: aim.gates_planes(w1[None, None, :, :4], w1[:, :32], bf)[2]):
        a, b = (fn(mode == "default") for mode in order)
        assert not torch.equal(a, b)
        assert fn(order[0] == "default") is a and fn(order[1] == "default") is b
