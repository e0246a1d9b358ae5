"""The port's CUDA kernels against their plain versions on the card (f32, TF32 off).

Marked `cuda`: each test skips without a card. On a machine with one:
    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from freqfusion_tpu_torch.ops import windows
from freqfusion_tpu_torch.models.fusion import FusionConfig, FusionHead
from freqfusion_tpu_torch.ops.kernels import (aim, bandmha, cab, conv3x3, lka, nafblock, sgfn,
                                              wattn)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _block_params(c, gen):
    def r(*shape, std):
        return torch.randn(*shape, generator=gen, device="cuda") * std
    p = {k: r(n, std=0.1) for k, n in (("ln1_b", c), ("b1", 2 * c), ("bdw", 2 * c),
                                       ("sca_b", c), ("b3", c), ("ln2_b", c),
                                       ("b4", 2 * c), ("b5", c))}
    p.update(ln1_w=1 + r(c, std=0.1), ln2_w=1 + r(c, std=0.1), beta=r(c, std=0.5),
             gamma=r(c, std=0.5), wdw=r(9, 2 * c, std=1 / 3))
    for k, shape in (("w1", (c, 2 * c)), ("sca_w", (c, c)), ("w3", (c, c)),
                     ("w4", (c, 2 * c)), ("w5", (c, c))):
        p[k] = r(*shape, std=c ** -0.5)
    return p


@pytest.mark.parametrize("b,h,w,c", [(2, 37, 45, 64), (1, 24, 32, 128), (1, 12, 20, 256),
                                     (2, 33, 29, 128), (1, 37, 45, 256), (1, 16, 14, 64),
                                     (1, 190, 200, 64), (2, 131, 139, 128), (2, 37, 45, 32),
                                     (1, 64, 80, 48), (1, 190, 200, 32), (1, 24, 32, 16),
                                     (1, 20, 22, 96), (1, 12, 20, 160), (1, 24, 32, 36),
                                     (2, 19, 23, 44), (1, 20, 22, 100), (1, 12, 20, 196)])
def test_fused_naf_block_kernel_matches_plain(gen, b, h, w, c):
    """B1 (stage A on the tensor cores) and B2 at NAF's three fused widths: ragged images whose
    tiles end inside and at the image's edge, with 6 x 14 outputs a block (C = 256, or an
    image too small to give every SM a larger tile) and 14 x 14 (the last two cases); and
    at C that is not a multiple of 8 (36, 44, 100, 196: B2's products on zero-padded
    weights, LN2 over the real C)."""
    x = torch.randn(b, h, w, c, generator=gen, device="cuda")
    p = _block_params(c, gen)
    n0 = dict(nafblock.launches)
    g, sums = nafblock.naf_block_stage_a(x, p["ln1_w"], p["ln1_b"], p["w1"], p["b1"],
                                         p["wdw"], p["bdw"])
    g_ref, sums_ref = nafblock.naf_block_stage_a_plain(x, p["ln1_w"], p["ln1_b"], p["w1"],
                                                       p["b1"], p["wdw"], p["bdw"])
    torch.testing.assert_close(g, g_ref, atol=1e-4, rtol=0)
    # sums are taken in another order: bound each by 1e-5 of its sum of |g|
    assert ((sums - sums_ref).abs() <= 1e-5 * g_ref.abs().sum((1, 2))).all()
    torch.testing.assert_close(nafblock.fused_naf_block(x, p),
                               nafblock.fused_naf_block_plain(x, p), atol=1e-4, rtol=0)
    assert nafblock.launches["naf_block_stage_a"] == n0["naf_block_stage_a"] + 2
    assert nafblock.launches["naf_block_stage_b"] == n0["naf_block_stage_b"] + 1


@pytest.mark.parametrize("cin,cout", [(3, 64), (64, 3), (180, 180)])
def test_conv3x3_kernel_matches_plain(gen, cin, cout):
    x = torch.randn(2, 37, 45, cin, generator=gen, device="cuda")
    w = torch.randn(3, 3, cin, cout, generator=gen, device="cuda") / (9 * cin) ** 0.5
    b = torch.randn(cout, generator=gen, device="cuda") * 0.1
    torch.testing.assert_close(conv3x3.conv3x3_dense(x, w, b),
                               conv3x3.conv3x3_dense_plain(x, w, b), atol=1e-4, rtol=0)


def _r(gen, *shape, std=1.0, mean=0.0):
    return mean + std * torch.randn(*shape, generator=gen, device="cuda")


@pytest.mark.parametrize("cin,cout", [(180, 180), (60, 180), (180, 60), (32, 48)])
def test_conv3x3_wide_case_matches_plain(gen, cin, cout):
    """The implicit-GEMM kernel (3xTF32 on the tensor cores) at widths that are and are not
    multiples of 8 and 64, on a ragged image at batch 2."""
    x = _r(gen, 2, 37, 45, cin)
    w, b = _r(gen, 3, 3, cin, cout, std=(9 * cin) ** -0.5), _r(gen, cout, std=0.1)
    n0 = conv3x3.launches["conv3x3_dense"]
    torch.testing.assert_close(conv3x3.conv3x3_dense(x, w, b),
                               conv3x3.conv3x3_dense_plain(x, w, b), atol=1e-4, rtol=0)
    assert conv3x3.launches["conv3x3_dense"] == n0 + 1


def _exactness(kernel, plain, ref64, tf32_plain):
    """f32-exactness of a 3xTF32 kernel: its max |Δ| against a float64 reference is within
    8x the plain f32 version's own, and the plain version in TF32 (what dropping the low
    terms would give) is not, so the check can tell the two apart."""
    err = (kernel.double() - ref64).abs().max().item()
    err_plain = (plain.double() - ref64).abs().max().item()
    err_tf32 = (tf32_plain.double() - ref64).abs().max().item()
    assert err <= 8 * err_plain, (err, err_plain)
    assert err_tf32 > 8 * err_plain, (err_tf32, err_plain)


def _tf32(fn, *args, **kw):
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        return fn(*args, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def test_conv3x3_wide_case_is_f32_exact(gen):
    """B3 at 180 -> 180 (K = 9 * 180 = 1620), inputs scaled x100."""
    x = 100 * _r(gen, 1, 48, 64, 180)
    w, b = _r(gen, 3, 3, 180, 180, std=1620 ** -0.5), _r(gen, 180, std=0.1)
    ref = conv3x3.conv3x3_dense_plain(x.double(), w.double(), b.double())
    _exactness(conv3x3.conv3x3_dense(x, w, b), conv3x3.conv3x3_dense_plain(x, w, b), ref,
               _tf32(conv3x3.conv3x3_dense_plain, x, w, b))


def test_cab_chain_is_f32_exact(gen):
    """B7 at C = 180, mid 60 (conv1's K = 1620), out_shift 8, inputs scaled x100."""
    args = (100 * _r(gen, 1, 48, 64, 180), _r(gen, 180, std=0.1, mean=1.0),
            _r(gen, 180, std=0.1), _r(gen, 3, 3, 180, 60, std=1620 ** -0.5),
            _r(gen, 60, std=0.1), 100 * _r(gen, 3, 3, 60, 180, std=540 ** -0.5),
            _r(gen, 180, std=0.1))
    ref, _ = cab.cab_chain_plain(*[a.double() for a in args], out_shift=8)
    _exactness(cab.cab_chain(*args, out_shift=8)[0], cab.cab_chain_plain(*args, out_shift=8)[0],
               ref, _tf32(cab.cab_chain_plain, *args, out_shift=8)[0])


def test_fused_hab_block_is_f32_exact(gen):
    """B8 at HAT-L's width with a shifted window and hidden 720 (fc2's K; the tail stages
    a pixel's whole K in shared memory, so 1620 is out of its reach), the output projection
    and fc2 scaled x100."""
    args = _hab_args(gen, 1, 32, 48, 180, 6, 16, 720)
    args[8], args[12] = 100 * args[8], 100 * args[12]
    types = torch.from_numpy(windows.shift_mask_types(16, 16, 8, 8).copy()).cuda()
    rest = (types, (16, 16), 6, 0.01)
    kw = dict(cab_scale=_r(gen, 1, 1, 1, 180, std=0.2, mean=0.5), in_shift=8)
    ref = wattn.fused_hab_block_plain(*[a.double() for a in args], types, *rest[1:],
                                      cab_scale=kw["cab_scale"].double(), in_shift=8)
    _exactness(wattn.fused_hab_block(*args, *rest, **kw),
               wattn.fused_hab_block_plain(*args, *rest, **kw), ref,
               _tf32(wattn.fused_hab_block_plain, *args, *rest, **kw))


def test_sgfn_tail_is_f32_exact(gen):
    """B6 at DAT's width, hidden 720 (fc1 C -> 720, fc2's K = 360), fc1's and fc2's weights
    scaled x100."""
    args = list(_sgfn_args(gen, 1, 24, 40, 180, 720))
    args[4], args[10] = 100 * args[4], 100 * args[10]
    ref = sgfn.fused_sgfn_tail_plain(*[a.double() for a in args])
    _exactness(sgfn.fused_sgfn_tail(*args), sgfn.fused_sgfn_tail_plain(*args), ref,
               _tf32(sgfn.fused_sgfn_tail_plain, *args))


def test_overlap_attention_is_f32_exact(gen):
    """B9 at HAT-L's width over all 576 keys of each 16 x 16 window (18 chunks of 32 keys
    through the online softmax), q and k scaled x2 (peaked scores), v and the projection
    x100."""
    args = (2 * _r(gen, 1, 32, 48, 180), 2 * _r(gen, 1, 32, 48, 180), 100 * _r(gen, 1, 32, 48, 180),
            100 * _r(gen, 180, 180, std=180 ** -0.5), _r(gen, 180, std=0.1),
            _r(gen, 6, 256, 576, std=0.5))
    ref = wattn.fused_overlap_attention_plain(*[a.double() for a in args], 16, 8, 6)
    _exactness(wattn.fused_overlap_attention(*args, 16, 8, 6),
               wattn.fused_overlap_attention_plain(*args, 16, 8, 6), ref,
               _tf32(wattn.fused_overlap_attention_plain, *args, 16, 8, 6))


def test_residual_ln_mlp_is_f32_exact(gen):
    """B10 at HAT-L's width with hidden 720 (fc2's K in three pieces), fc1's and fc2's
    weights scaled x100."""
    c, hid = 180, 720
    args = (_r(gen, 1, 24, 40, c), _r(gen, 1, 24, 40, c), _r(gen, c, std=0.1, mean=1.0),
            _r(gen, c, std=0.1), 100 * _r(gen, c, hid, std=c ** -0.5), _r(gen, hid, std=0.1),
            100 * _r(gen, hid, c, std=hid ** -0.5), _r(gen, c, std=0.1))
    ref = wattn.fused_residual_ln_mlp_plain(*[a.double() for a in args])
    _exactness(wattn.fused_residual_ln_mlp(*args), wattn.fused_residual_ln_mlp_plain(*args),
               ref, _tf32(wattn.fused_residual_ln_mlp_plain, *args))


def test_window_attention_xqkv_is_f32_exact(gen):
    """B4 at DAT's branch (Cin 180, 3 heads of 30, 8 x 32 windows, shifted), x scaled x2
    (peaked scores) and the v columns of the projection x100."""
    x = 2 * _r(gen, 1, 16, 64, 180)
    wqkv, bqkv = _r(gen, 180, 270, std=180 ** -0.5), _r(gen, 270, std=0.1)
    wqkv[:, 180:] *= 100
    types = torch.from_numpy(windows.shift_mask_types(8, 32, 4, 16).copy()).cuda()
    args = (x, wqkv, bqkv, _r(gen, 3, 256, 256, std=0.5), types, (8, 32), 3)
    ref = wattn.fused_window_attention_xqkv_plain(*[a.double() for a in args[:4]], *args[4:])
    _exactness(wattn.fused_window_attention_xqkv(*args),
               wattn.fused_window_attention_xqkv_plain(*args), ref,
               _tf32(wattn.fused_window_attention_xqkv_plain, *args))


@pytest.mark.parametrize("hs,ws,c,heads", [(8, 32, 90, 3), (24, 24, 96, 1)])
def test_window_attention_qkv_is_f32_exact(gen, hs, ws, c, heads):
    """B13 at DAT's branch (3 heads of 30, 8 x 32 windows, shifted) and at 576 tokens with a
    head of 96 (q from shared memory, the output in three pieces), q and k scaled x2 (peaked
    scores) and v x100."""
    h, w = 2 * hs, 2 * ws
    types = torch.from_numpy(windows.shift_mask_types(hs, ws, hs // 2, ws // 2).copy()).cuda()
    args = (2 * _r(gen, 1, h, w, c), 2 * _r(gen, 1, h, w, c), 100 * _r(gen, 1, h, w, c),
            _r(gen, heads, hs * ws, hs * ws, std=0.5), types, (hs, ws), heads)
    ref = wattn.fused_window_attention_qkv_plain(*[a.double() for a in args[:4]], *args[4:])
    _exactness(wattn.fused_window_attention_qkv(*args),
               wattn.fused_window_attention_qkv_plain(*args), ref,
               _tf32(wattn.fused_window_attention_qkv_plain, *args))


@pytest.mark.parametrize("c,hw", [(64, (20, 30)), (64, (190, 200)), (256, (20, 30)),
                                  (48, (37, 45))])
def test_naf_stage_a_is_f32_exact(gen, c, hw):
    """B1's g on its 6 x 14 tile (K in 2 and 8 chunks) and on the 14 x 14 tile of an image
    that fills the card (K in one chunk a pass), w1 scaled x100."""
    p = _block_params(c, gen)
    args = (_r(gen, 1, *hw, c), p["ln1_w"], p["ln1_b"], 100 * p["w1"], p["b1"], p["wdw"],
            p["bdw"])
    ref, _ = nafblock.naf_block_stage_a_plain(*[a.double() for a in args])
    _exactness(nafblock.naf_block_stage_a(*args)[0], nafblock.naf_block_stage_a_plain(*args)[0],
               ref, _tf32(nafblock.naf_block_stage_a_plain, *args)[0])


@pytest.mark.parametrize("c,hw", [(64, (37, 45)), (128, (19, 23)), (256, (13, 17)),
                                  (32, (37, 45))])
def test_naf_stage_b_is_f32_exact(gen, c, hw):
    """B2 on chip (C = 64) and through device memory (128; 256 with K in two pieces), on
    pixel counts that end inside a 128-row tile, w3 and w5 scaled x100."""
    p = _block_params(c, gen)
    g = _r(gen, 1, *hw, c)
    att = _r(gen, 1, c, std=0.5, mean=1.0)
    args = [g, _r(gen, 1, *hw, c), att, 100 * p["w3"], p["b3"], p["beta"], p["ln2_w"],
            p["ln2_b"], p["w4"], p["b4"], 100 * p["w5"], p["b5"], p["gamma"]]
    ref = nafblock.naf_block_stage_b_plain(*[a.double() for a in args])
    _exactness(nafblock.naf_block_stage_b(*args), nafblock.naf_block_stage_b_plain(*args), ref,
               _tf32(nafblock.naf_block_stage_b_plain, *args))


@pytest.mark.parametrize("hw", [(37, 45), (19, 23)])
def test_naf_stage_b_via_memory_is_f32_exact(gen, hw):
    """B2 at C = 64 in the device-memory design of the wider levels (on_chip=False), ragged,
    w3 and w5 scaled x100."""
    c = 64
    p = _block_params(c, gen)
    args = [_r(gen, 2, *hw, c), _r(gen, 2, *hw, c), _r(gen, 2, c, std=0.5, mean=1.0),
            100 * p["w3"], p["b3"], p["beta"], p["ln2_w"], p["ln2_b"], p["w4"], p["b4"],
            100 * p["w5"], p["b5"], p["gamma"]]
    ref = nafblock.naf_block_stage_b_plain(*[a.double() for a in args])
    _exactness(nafblock.naf_block_stage_b(*args, on_chip=False),
               nafblock.naf_block_stage_b_plain(*args), ref,
               _tf32(nafblock.naf_block_stage_b_plain, *args))


@pytest.mark.parametrize("h,w,c,on_chip", [(352, 512, 256, True), (704, 1024, 128, True),
                                           (1408, 2048, 64, True), (1408, 2048, 64, False)])
def test_naf_stage_b_matches_plain_over_many_waves(gen, h, w, c, on_chip):
    """B2 at NAF's served shapes, several waves of blocks a launch, launched five times: blocks
    run in no order, so a block that touched another's scratch rows (C = 256 parks its K
    pieces' partial sums) would show here as a result that differs from plain or from run to
    run."""
    p = _block_params(c, gen)
    args = [_r(gen, 1, h, w, c), _r(gen, 1, h, w, c), _r(gen, 1, c, std=0.5, mean=1.0),
            p["w3"], p["b3"], p["beta"], p["ln2_w"], p["ln2_b"], p["w4"], p["b4"], p["w5"],
            p["b5"], p["gamma"]]
    ref = nafblock.naf_block_stage_b_plain(*args)
    first = nafblock.naf_block_stage_b(*args, on_chip=on_chip)
    torch.testing.assert_close(first, ref, atol=1e-4, rtol=0)
    for _ in range(4):
        assert torch.equal(nafblock.naf_block_stage_b(*args, on_chip=on_chip), first)


@pytest.mark.parametrize("swap", [False, True])
def test_aim_gates_proj_is_f32_exact(gen, swap):
    """B5b at DAT's width (C = 180, the S-Map 11 wide) on a ragged batch of two, both
    wirings, the projection scaled x100."""
    p = _aim_params(gen, 180)
    args = [_r(gen, 2, 19, 23, 180), _r(gen, 2, 19, 23, 180), _r(gen, 2, 1, 1, 180),
            p["si_w1"], p["si_b1"], p["si_s"], p["si_b"], p["si_w2"], p["si_b2"],
            100 * p["proj_w"], p["proj_b"]]
    ref = aim.aim_gates_proj_plain(*[a.double() for a in args], swap=swap)
    _exactness(aim.aim_gates_proj(*args, swap=swap), aim.aim_gates_proj_plain(*args, swap=swap),
               ref, _tf32(aim.aim_gates_proj_plain, *args, swap=swap))


@pytest.mark.parametrize("b,h,w,hs,ws,cin,heads,hd,with_mask", [
    (2, 16, 64, 8, 32, 180, 3, 30, True), (1, 64, 32, 32, 8, 180, 3, 30, False),
    (2, 16, 32, 8, 8, 24, 2, 6, True), (1, 8, 32, 8, 16, 64, 4, 32, True),
    (1, 32, 64, 8, 32, 180, 3, 30, False), (2, 64, 32, 32, 8, 180, 3, 30, True),
    (2, 192, 192, 8, 32, 180, 3, 30, True), (2, 192, 192, 32, 8, 180, 3, 30, False)])
def test_window_attention_xqkv_kernel_matches_plain(gen, b, h, w, hs, ws, cin, heads, hd,
                                                    with_mask):
    """B4 on the shared tensor-core attention kernel (no LayerNorm): DAT's 8 x 32 and 32 x 8
    windows unshifted and shifted, at batch 2 and at a tile's shape, co = heads * hd unlike
    Cin, and windows of 64 and 128 tokens."""
    n, co = hs * ws, heads * hd
    x = _r(gen, b, h, w, cin)
    wqkv, bqkv = _r(gen, cin, 3 * co, std=cin ** -0.5), _r(gen, 3 * co, std=0.1)
    bias = _r(gen, heads, n, n, std=0.5)
    mask = windows.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2) if with_mask else None
    n0 = wattn.launches["fused_window_attention_xqkv"]
    got = wattn.fused_window_attention_xqkv(x, wqkv, bqkv, bias, mask, (hs, ws), heads)
    want = wattn.fused_window_attention_xqkv_plain(x, wqkv, bqkv, bias, mask, (hs, ws), heads)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert wattn.launches["fused_window_attention_xqkv"] == n0 + 1
    if with_mask:   # the 4 window types as a tensor, as the model hands them over
        types = torch.from_numpy(
            windows.shift_mask_types(hs, ws, hs // 2, ws // 2).copy()).cuda()
        again = wattn.fused_window_attention_xqkv(x, wqkv, bqkv, bias, types, (hs, ws), heads)
        torch.testing.assert_close(again, got, atol=0, rtol=0)


def test_window_attention_xqkv_takes_a_branch_of_the_whole_projection(gen):
    """DAT hands B4 its whole qkv parameter (a view) and the branch's columns: the result is
    that of the branch's own [Cin, 3 co] projection, and the kept slabs follow the weight
    when it changes in place."""
    lin = torch.nn.Linear(180, 540).cuda()
    x, bias = _r(gen, 1, 16, 64, 180), _r(gen, 3, 256, 256, std=0.5)
    with torch.no_grad():
        for _ in range(2):
            for br in range(2):
                w, bq = lin.weight.t(), lin.bias
                got = wattn.fused_window_attention_xqkv(x, w, bq, bias, None, (8, 32), 3,
                                                        (90 * br, 90))
                wb, bb = wattn.branch_qkv(w, bq, 90 * br, 90)
                torch.testing.assert_close(
                    got, wattn.fused_window_attention_xqkv_plain(x, wb, bb, bias, None, (8, 32),
                                                                 3), atol=1e-4, rtol=0)
            lin.weight.mul_(0.5)
            lin.bias.add_(0.1)


@pytest.mark.parametrize("b,h,w,hs,ws,c,heads,with_mask", [
    (2, 192, 192, 8, 32, 90, 3, True), (1, 64, 96, 32, 8, 90, 3, False),
    (2, 30, 45, 15, 15, 180, 6, True), (1, 27, 18, 9, 9, 24, 4, True),
    (2, 48, 24, 24, 24, 64, 2, True), (1, 16, 16, 8, 8, 32, 1, False),
    (2, 14, 21, 7, 7, 8, 2, True), (2, 8, 16, 4, 8, 32, 2, True),
    (1, 8, 12, 4, 4, 48, 4, True), (2, 3, 5, 1, 1, 8, 2, False),
    (1, 32, 32, 32, 32, 24, 4, False), (1, 24, 48, 12, 12, 96, 2, True),
    (1, 24, 48, 6, 24, 96, 2, True), (1, 16, 32, 16, 16, 128, 2, False),
    (1, 16, 16, 8, 8, 192, 2, True), (2, 15, 10, 5, 5, 90, 2, True)])
def test_window_attention_qkv_kernel_matches_plain(gen, b, h, w, hs, ws, c, heads, with_mask):
    """B13 at DAT's tile shape, at windows whose token count is no multiple of 32 (225, 81,
    49, 25), above 256 tokens (576, 1024), at 144 (HAT's window 12, DAT's split (6, 24)),
    under 64 (32, 16 and a single token), at heads of 45, 48, 64 and 96 and at batch 2,
    with the mask types taken from each window's place."""
    n = hs * ws
    q, k, v = (_r(gen, b, h, w, c) for _ in range(3))
    bias = _r(gen, heads, n, n, std=0.5)
    mask = windows.shift_attn_mask(h, w, hs, ws, hs // 2, ws // 2) if with_mask else None
    n0 = wattn.launches["fused_window_attention_qkv"]
    got = wattn.fused_window_attention_qkv(q, k, v, bias, mask, (hs, ws), heads)
    want = wattn.fused_window_attention_qkv_plain(q, k, v, bias, mask, (hs, ws), heads)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert wattn.launches["fused_window_attention_qkv"] == n0 + 1


@pytest.mark.parametrize("b,h,w,ws,c,heads,with_mask", [
    (1, 45, 45, 15, 180, 6, True), (2, 30, 45, 15, 180, 6, False), (2, 27, 9, 9, 24, 4, True),
    (1, 32, 48, 16, 180, 6, True), (1, 48, 24, 24, 48, 2, False), (3, 8, 16, 8, 20, 2, True),
    (1, 8, 12, 4, 48, 4, True), (2, 6, 4, 2, 8, 2, False), (1, 24, 48, 12, 96, 2, True),
    (1, 32, 32, 16, 192, 3, True)])
def test_window_attention_kernel_matches_plain(gen, b, h, w, ws, c, heads, with_mask):
    """B14 at HAT-L's width with an odd window (odd H and W, 225 tokens), at window 9, at
    the served window 16, at 576 tokens, at windows under 8 px (4 and 2), at window 12 with
    heads of 48 and window 16 with heads of 64 (what B8 refuses), and at batch 2 and 3."""
    n = ws * ws
    args = (_r(gen, b, h, w, c), _r(gen, c, 3 * c, std=c ** -0.5), _r(gen, 3 * c, std=0.1),
            _r(gen, c, c, std=c ** -0.5), _r(gen, c, std=0.1), _r(gen, heads, n, n, std=0.5),
            windows.shift_attn_mask(h, w, ws, ws, ws // 2, ws // 2) if with_mask else None)
    n0 = dict(wattn.launches)
    got = wattn.fused_window_attention(*args, (ws, ws), heads)
    want = wattn.fused_window_attention_plain(*args, (ws, ws), heads)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    # one launch of B14, none counted for the kernels it is made of
    assert {k: wattn.launches[k] - n0[k] for k in n0 if wattn.launches[k] != n0[k]} == {
        "fused_window_attention": 1}


def test_window_attention_wrappers_raise_on_what_the_kernel_does_not_take(gen):
    q = _r(gen, 1, 32, 32, 24)
    with pytest.raises(ValueError, match="multiple of the 8x32 window"):
        wattn.fused_window_attention_qkv(q[:, :30].contiguous(), q[:, :30].contiguous(),
                                         q[:, :30].contiguous(), _r(gen, 4, 256, 256), None,
                                         (8, 32), 4)
    with pytest.raises(ValueError, match="whole heads"):
        wattn.fused_window_attention_qkv(q, q, q, _r(gen, 5, 64, 64), None, (8, 8), 5)
    with pytest.raises(ValueError, match="contiguous"):
        wattn.fused_window_attention_qkv(q.transpose(1, 2), q, q, _r(gen, 4, 64, 64), None,
                                         (8, 8), 4)
    with pytest.raises(ValueError, match="expected shape"):
        wattn.fused_window_attention(q, _r(gen, 24, 70), _r(gen, 72), _r(gen, 24, 24),
                                     _r(gen, 24), _r(gen, 4, 64, 64), None, (8, 8), 4)
    # no backward: a tensor that autograd would follow is refused, not served without it
    bias = _r(gen, 4, 64, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        wattn.fused_window_attention_qkv(q.clone().requires_grad_(), q, q, bias, None, (8, 8), 4)
    proj = (_r(gen, 24, 72).requires_grad_(), _r(gen, 72), _r(gen, 24, 24), _r(gen, 24))
    with pytest.raises(RuntimeError, match="no backward"):
        wattn.fused_window_attention(q, *proj, bias, None, (8, 8), 4)
    with torch.no_grad():
        assert wattn.fused_window_attention(q, *proj, bias, None, (8, 8), 4).shape == q.shape


def test_dat_on_the_card_takes_the_kernel_its_shape_asks_for(gen):
    """A CUDA image of whole windows launches the in-kernel-qkv attention twice a spatial
    block; one that is not, or whose windows hold fewer than 64 tokens or a count B4 does not
    take (144), projects first, pads and launches the pre-projected kernel. Each agrees with
    the plain path."""
    from freqfusion_tpu_torch.models.dat import DAT
    cfg = dict(embed_dim=64, depths=(2,), num_heads=(4,), expansion=2.0)
    model = DAT(split_size=(8, 8), **cfg).cuda().eval()
    names = ("fused_window_attention_xqkv", "fused_window_attention_qkv")

    def run(m, x):
        n0 = [wattn.launches[k] for k in names]
        with torch.inference_mode():
            sr, _ = m(x)
            for mod in m.modules():
                if hasattr(mod, "kernels"):
                    mod.kernels = False
            plain, _ = m(x)
            for mod in m.modules():
                if hasattr(mod, "kernels"):
                    mod.kernels = True
        torch.testing.assert_close(sr, plain, atol=1e-3 * plain.abs().max().item(), rtol=0)
        return sr.shape, tuple(wattn.launches[k] - n for k, n in zip(names, n0))

    whole = torch.rand(2, 16, 24, 3, generator=gen, device="cuda")
    ragged = torch.rand(2, 20, 27, 3, generator=gen, device="cuda")
    assert run(model, whole) == ((2, 64, 96, 3), (2, 0))
    assert run(model, ragged) == ((2, 80, 108, 3), (0, 2))
    small = DAT(split_size=(4, 8), **cfg).cuda().eval()   # 32 tokens a window
    assert run(small, whole) == ((2, 64, 96, 3), (0, 2))
    wide = DAT(split_size=(6, 24), **cfg).cuda().eval()  # 144 tokens: B4 refuses them
    assert run(wide, torch.rand(1, 24, 48, 3, generator=gen, device="cuda")) == (
        (1, 96, 192, 3), (0, 2))


def _aim_params(gen, c, mid=None):
    mid = mid or max(c // 16, 1)
    return dict(wdw=_r(gen, 3, 3, 1, c, std=1 / 3), bdw=_r(gen, c, std=0.1),
                bn_s=_r(gen, c, std=0.2, mean=1.0), bn_b=_r(gen, c, std=0.1),
                si_w1=_r(gen, 1, 1, c, mid, std=c ** -0.5), si_b1=_r(gen, mid, std=0.1),
                si_s=_r(gen, mid, std=0.2, mean=1.0), si_b=_r(gen, mid, std=0.1),
                si_w2=_r(gen, 1, 1, mid, 1, std=mid ** -0.5), si_b2=_r(gen, 1, std=0.1),
                proj_w=_r(gen, c, c, std=c ** -0.5), proj_b=_r(gen, c, std=0.1))


@pytest.mark.parametrize("b,h,w,c", [(2, 37, 45, 180), (1, 8, 32, 64), (3, 5, 7, 20)])
def test_aim_kernels_match_plain(gen, b, h, w, c):
    p = _aim_params(gen, c)
    v, att, chmap = _r(gen, b, h, w, c), _r(gen, b, h, w, c), _r(gen, b, 1, 1, c)
    a_args = (v, p["wdw"], p["bdw"], p["bn_s"], p["bn_b"])
    n0 = dict(aim.launches)
    cx, sums = aim.aim_conv_branch(*a_args)
    cx_ref, sums_ref = aim.aim_conv_branch_plain(*a_args)
    torch.testing.assert_close(cx, cx_ref, atol=1e-4, rtol=0)
    # sums are taken in another order: bound each by 1e-5 of its sum of |conv_x|
    assert ((sums - sums_ref).abs() <= 1e-5 * cx_ref.abs().sum((1, 2), keepdim=True)).all()
    for swap in (False, True):
        b_args = (att, cx_ref, chmap, p["si_w1"], p["si_b1"], p["si_s"], p["si_b"],
                  p["si_w2"], p["si_b2"], p["proj_w"], p["proj_b"])
        torch.testing.assert_close(aim.aim_gates_proj(*b_args, swap=swap),
                                   aim.aim_gates_proj_plain(*b_args, swap=swap),
                                   atol=1e-4, rtol=0)
    assert aim.launches["aim_conv_branch"] == n0["aim_conv_branch"] + 1
    assert aim.launches["aim_gates_proj"] == n0["aim_gates_proj"] + 2


@pytest.mark.parametrize("b,h,w,c", [(1, 352, 512, 180), (2, 192, 192, 180), (2, 37, 45, 180),
                                     (1, 19, 23, 1024), (2, 9, 40, 256), (1, 5, 70, 4)])
def test_aim_conv_branch_matches_plain_and_repeats_bit_for_bit(gen, b, h, w, c):
    """B5a at DAT's bucket, a chunk of two tiles and a ragged image, and at widths that take
    channel slices (256: two of 32 quads; 1024: six, the last short): within 1e-4 of plain,
    the sums within 1e-5 of their sum of |conv_x|, and the same bits over five launches (its
    sums add in a fixed order)."""
    p = _aim_params(gen, c)
    args = (_r(gen, b, h, w, c), p["wdw"], p["bdw"], p["bn_s"], p["bn_b"])
    cx, sums = aim.aim_conv_branch(*args)
    cx_ref, sums_ref = aim.aim_conv_branch_plain(*args)
    torch.testing.assert_close(cx, cx_ref, atol=1e-4, rtol=0)
    assert ((sums - sums_ref).abs() <= 1e-5 * cx_ref.abs().sum((1, 2), keepdim=True)).all()
    for _ in range(5):
        again, again_sums = aim.aim_conv_branch(*args)
        assert torch.equal(again, cx) and torch.equal(again_sums, sums)


@pytest.mark.parametrize("c,mid", [(256, 16), (256, 32), (180, 24), (200, 13), (1024, 64)])
def test_aim_gates_proj_takes_wide_rows_and_s_maps(gen, c, mid):
    """B5b above 192 channels (the projection's K in pieces: 128 + 128 at 256, 104 + 96 at
    200) and above the 12 S-Map sums a lane keeps (groups of 12, a pass each), both
    wirings, within 1e-4 of plain."""
    p = _aim_params(gen, c, mid)
    args = (_r(gen, 2, 19, 23, c), _r(gen, 2, 19, 23, c), _r(gen, 2, 1, 1, c), p["si_w1"],
            p["si_b1"], p["si_s"], p["si_b"], p["si_w2"], p["si_b2"], p["proj_w"], p["proj_b"])
    for swap in (False, True):
        torch.testing.assert_close(aim.aim_gates_proj(*args, swap=swap),
                                   aim.aim_gates_proj_plain(*args, swap=swap), atol=1e-4, rtol=0)


def _sgfn_args(gen, b, h, w, c, hidden):
    half = hidden // 2
    return (_r(gen, b, h, w, c), _r(gen, b, h, w, c), _r(gen, c, std=0.1, mean=1.0),
            _r(gen, c, std=0.1), _r(gen, c, hidden, std=c ** -0.5), _r(gen, hidden, std=0.1),
            _r(gen, half, std=0.1, mean=1.0), _r(gen, half, std=0.1),
            _r(gen, 3, 3, 1, half, std=1 / 3), _r(gen, half, std=0.1),
            _r(gen, half, c, std=half ** -0.5), _r(gen, c, std=0.1))


@pytest.mark.parametrize("b,h,w,c,hidden", [(2, 37, 45, 180, 720), (1, 8, 32, 64, 128),
                                            (3, 5, 7, 20, 40), (2, 192, 192, 180, 720)])
def test_sgfn_tail_kernel_matches_plain(gen, b, h, w, c, hidden):
    args = _sgfn_args(gen, b, h, w, c, hidden)
    n0 = sgfn.launches["fused_sgfn_tail"]
    torch.testing.assert_close(sgfn.fused_sgfn_tail(*args), sgfn.fused_sgfn_tail_plain(*args),
                               atol=1e-4, rtol=0)
    assert sgfn.launches["fused_sgfn_tail"] == n0 + 1


def test_dat_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = _r(gen, 1, 16, 32, 24)
    wqkv, bqkv, bias = _r(gen, 24, 36), _r(gen, 36), _r(gen, 2, 128, 128)
    with pytest.raises(ValueError, match="multiple of the"):
        wattn.fused_window_attention_xqkv(x[:, :15].contiguous(), wqkv, bqkv, bias, None,
                                          (8, 16), 2)
    with pytest.raises(ValueError, match="tokens per window"):
        wattn.fused_window_attention_xqkv(x, wqkv, bqkv, _r(gen, 2, 8, 8), None, (2, 4), 2)
    with pytest.raises(ValueError, match="heads up to"):
        wattn.fused_window_attention_xqkv(x, _r(gen, 24, 3 * 40), _r(gen, 3 * 40),
                                          _r(gen, 1, 128, 128), None, (8, 16), 1)
    with pytest.raises(TypeError, match="numpy"):
        wattn.fused_window_attention_xqkv(x, wqkv, bqkv, bias, torch.zeros(2, 128, 128),
                                          (8, 16), 2)
    with pytest.raises(ValueError, match="window type"):
        bad = np.array(windows.shift_attn_mask(24, 48, 8, 16, 4, 8))
        bad[4, 0, 1] = -100.0   # the middle one of 3 x 3 windows is no longer interior
        wattn.fused_window_attention_xqkv(_r(gen, 1, 24, 48, 24), wqkv, bqkv, bias, bad,
                                          (8, 16), 2)
    with pytest.raises(ValueError, match="float32"):
        wattn.fused_window_attention_xqkv(x.double(), wqkv, bqkv, bias, None, (8, 16), 2)
    p = _aim_params(gen, 18)
    with pytest.raises(ValueError, match="multiple of 4"):
        aim.aim_conv_branch(_r(gen, 1, 4, 4, 18), p["wdw"], p["bdw"], p["bn_s"], p["bn_b"])
    p = _aim_params(gen, 20)
    with pytest.raises(ValueError, match="contiguous"):
        aim.aim_conv_branch(_r(gen, 1, 4, 20, 4).transpose(2, 3), p["wdw"], p["bdw"],
                            p["bn_s"], p["bn_b"])
    with pytest.raises(ValueError, match="expected shape"):
        aim.aim_gates_proj(_r(gen, 1, 4, 4, 20), _r(gen, 1, 4, 5, 20), _r(gen, 1, 1, 1, 20),
                           p["si_w1"], p["si_b1"], p["si_s"], p["si_b"], p["si_w2"],
                           p["si_b2"], p["proj_w"], p["proj_b"])
    args = list(_sgfn_args(gen, 1, 4, 4, 20, 40))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        sgfn.fused_sgfn_tail(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(ValueError, match="multiples of 4"):
        sgfn.fused_sgfn_tail(*_sgfn_args(gen, 1, 4, 4, 20, 36))


@pytest.mark.parametrize("b,h,w,c,mid,shift", [(2, 37, 45, 180, 60, 0), (1, 32, 64, 180, 60, 8),
                                               (2, 24, 40, 24, 8, 4), (1, 5, 7, 12, 4, 3)])
def test_cab_chain_kernel_matches_plain(gen, b, h, w, c, mid, shift):
    args = (_r(gen, b, h, w, c), _r(gen, c, std=0.1, mean=1.0), _r(gen, c, std=0.1),
            _r(gen, 3, 3, c, mid, std=(9 * c) ** -0.5), _r(gen, mid, std=0.1),
            _r(gen, 3, 3, mid, c, std=(9 * mid) ** -0.5), _r(gen, c, std=0.1))
    n0 = cab.launches["cab_chain"]
    u, sums = cab.cab_chain(*args, out_shift=shift)
    u_ref, sums_ref = cab.cab_chain_plain(*args, out_shift=shift)
    torch.testing.assert_close(u, u_ref, atol=1e-4, rtol=0)
    # sums are taken in another order: bound each by 1e-5 of its sum of |u|
    assert ((sums - sums_ref).abs() <= 1e-5 * u_ref.abs().sum((1, 2), keepdim=True)).all()
    assert cab.launches["cab_chain"] == n0 + 1


def _hab_args(gen, b, h, w, c, heads, window, hidden):
    n = window * window
    return [_r(gen, b, h, w, c), _r(gen, b, h, w, c, std=3.0),
            _r(gen, c, std=0.1, mean=1.0), _r(gen, c, std=0.1),
            _r(gen, c, std=0.1, mean=1.0), _r(gen, c, std=0.1),
            _r(gen, c, 3 * c, std=c ** -0.5), _r(gen, 3 * c, std=0.1),
            _r(gen, c, c, std=c ** -0.5), _r(gen, c, std=0.1),
            _r(gen, c, hidden, std=c ** -0.5), _r(gen, hidden, std=0.1),
            _r(gen, hidden, c, std=hidden ** -0.5), _r(gen, c, std=0.1),
            _r(gen, heads, n, n, std=0.5)]


@pytest.mark.parametrize("b,h,w,c,heads,window,mode", [
    (2, 32, 48, 180, 6, 16, "plain"), (2, 32, 48, 180, 6, 16, "in_shift"),
    (1, 16, 32, 180, 6, 16, "rolled"), (2, 16, 24, 24, 4, 8, "in_shift"),
    (1, 16, 16, 64, 2, 8, "plain"), (2, 192, 192, 180, 6, 16, "plain"),
    (2, 192, 192, 180, 6, 16, "in_shift")])
def test_fused_hab_block_kernel_matches_plain(gen, b, h, w, c, heads, window, mode):
    args = _hab_args(gen, b, h, w, c, heads, window, 2 * c)
    s = 0 if mode == "plain" else window // 2
    mask = None
    if mode == "in_shift":   # the 4 window types as the model hands them over
        mask = torch.from_numpy(windows.shift_mask_types(window, window, s, s).copy()).cuda()
    elif mode == "rolled":   # the whole image's numpy mask, reduced by the wrapper
        mask = windows.shift_attn_mask(h, w, window, window, s, s)
    kw = dict(cab_scale=_r(gen, b, 1, 1, c, std=0.2, mean=0.5),
              in_shift=s if mode == "in_shift" else 0)
    n0 = wattn.launches["fused_hab_block"]
    got = wattn.fused_hab_block(*args, mask, (window, window), heads, 0.01, **kw)
    want = wattn.fused_hab_block_plain(*args, mask, (window, window), heads, 0.01, **kw)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert wattn.launches["fused_hab_block"] == n0 + 1
    kw["cab_scale"] = None
    torch.testing.assert_close(
        wattn.fused_hab_block(*args, mask, (window, window), heads, 0.01, **kw),
        wattn.fused_hab_block_plain(*args, mask, (window, window), heads, 0.01, **kw),
        atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,h,w,c,heads,window", [(2, 32, 48, 180, 6, 16), (1, 16, 16, 180, 6, 16),
                                                  (2, 16, 24, 24, 4, 8), (1, 8, 12, 8, 2, 4),
                                                  (2, 192, 192, 180, 6, 16),
                                                  (1, 32, 32, 24, 4, 32), (1, 64, 32, 96, 2, 32),
                                                  (1, 32, 48, 96, 2, 16)])
def test_overlap_attention_kernel_matches_plain(gen, b, h, w, c, heads, window):
    """B9 at HAT-L's width, small windows, HAT's window 32 (2304 keys) and heads of 48."""
    ov = window // 2
    args = (_r(gen, b, h, w, c), _r(gen, b, h, w, c), _r(gen, b, h, w, c),
            _r(gen, c, c, std=c ** -0.5), _r(gen, c, std=0.1),
            _r(gen, heads, window ** 2, (window + ov) ** 2, std=0.5))
    n0 = wattn.launches["fused_overlap_attention"]
    torch.testing.assert_close(
        wattn.fused_overlap_attention(*args, window, ov, heads),
        wattn.fused_overlap_attention_plain(*args, window, ov, heads), atol=1e-4, rtol=0)
    assert wattn.launches["fused_overlap_attention"] == n0 + 1


@pytest.mark.parametrize("shape,hidden", [((2, 37, 45, 180), 360), ((1, 8, 32, 64), 128),
                                          ((3, 5, 7, 20), 40), ((130, 12), 24)])
def test_residual_ln_mlp_kernel_matches_plain(gen, shape, hidden):
    c = shape[-1]
    args = (_r(gen, *shape), _r(gen, *shape), _r(gen, c, std=0.1, mean=1.0),
            _r(gen, c, std=0.1), _r(gen, c, hidden, std=c ** -0.5), _r(gen, hidden, std=0.1),
            _r(gen, hidden, c, std=hidden ** -0.5), _r(gen, c, std=0.1))
    n0 = wattn.launches["fused_residual_ln_mlp"]
    torch.testing.assert_close(wattn.fused_residual_ln_mlp(*args),
                               wattn.fused_residual_ln_mlp_plain(*args), atol=1e-4, rtol=0)
    assert wattn.launches["fused_residual_ln_mlp"] == n0 + 1


def test_hat_on_the_card_takes_the_kernels_its_shape_asks_for(gen):
    """A small HAT on the card launches B7 and B8 in every HAB, B9 and B10 in every OCAB and
    B3 in the seam convs; with an odd window (odd H and W) every HAB launches the standalone
    window attention instead, and so does a window under 8 px. Each agrees with the plain
    path."""
    from freqfusion_tpu_torch.models.hat import HAT
    cfg = dict(embed_dim=48, depths=(2, 2), num_heads=(4, 4), squeeze=6, num_feat=16)

    def run(model, x):
        n0 = dict(wattn.launches, **cab.launches, **conv3x3.launches)
        with torch.inference_mode():
            sr, deep = model(x)
            after = dict(wattn.launches, **cab.launches, **conv3x3.launches)
            for m in model.modules():
                if hasattr(m, "kernels"):
                    m.kernels = False
            sr_plain, deep_plain = model(x)
        assert dict(wattn.launches, **cab.launches, **conv3x3.launches) == after
        torch.testing.assert_close(sr, sr_plain, atol=1e-3 * sr_plain.abs().max().item(),
                                   rtol=0)
        torch.testing.assert_close(deep, deep_plain,
                                   atol=1e-3 * deep_plain.abs().max().item(), rtol=0)
        return {k: after[k] - n0[k] for k in after if after[k] != n0[k]}

    x = torch.rand(2, 32, 48, 3, generator=gen, device="cuda")
    assert run(HAT(window=16, **cfg).cuda().eval(), x) == {
        "cab_chain": 4, "fused_hab_block": 4, "fused_overlap_attention": 2,
        "fused_residual_ln_mlp": 2, "conv3x3_dense": 3}
    # window 9 on 27x18: every HAB fails the even-sides gate; the OCAB (window 9) is outside
    # its own gate and runs in torch with the plain tail
    odd = HAT(window=9, overlap_ratio=0.45, **cfg).cuda().eval()
    y = torch.rand(2, 27, 18, 3, generator=gen, device="cuda")
    assert run(odd, y) == {"fused_window_attention": 4, "conv3x3_dense": 3}
    small = HAT(window=4, **cfg).cuda().eval()
    assert run(small, torch.rand(1, 8, 12, 3, generator=gen, device="cuda")) == {
        "fused_window_attention": 4, "conv3x3_dense": 3}
    # window 12 (144 tokens) and heads of 48: B8 refuses both, so every HAB runs B7, B14 and
    # B10; the OCAB (window 12) is outside its gate
    wide = HAT(window=12, embed_dim=96, depths=(2, 2), num_heads=(2, 2), squeeze=6,
               num_feat=16).cuda().eval()
    assert run(wide, torch.rand(1, 24, 36, 3, generator=gen, device="cuda")) == {
        "cab_chain": 4, "fused_window_attention": 4, "fused_residual_ln_mlp": 4,
        "conv3x3_dense": 3}


def test_hat_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    args = _hab_args(gen, 1, 16, 16, 24, 4, 8, 48)
    types = torch.from_numpy(windows.shift_mask_types(8, 8, 4, 4).copy()).cuda()
    with pytest.raises(ValueError, match="needs a shift mask"):
        wattn.fused_hab_block(*args, None, (8, 8), 4, 0.01, in_shift=4)
    with pytest.raises(ValueError, match="square window"):
        wattn.fused_hab_block(*args, None, (8, 16), 4, 0.01)
    with pytest.raises(ValueError, match="tokens per window"):
        wattn.fused_hab_block(*args[:14], _r(gen, 4, 16, 16), None, (4, 4), 4, 0.01)
    with pytest.raises(ValueError, match="expected shape"):
        wattn.fused_hab_block(args[0], args[1][:, :8].contiguous(), *args[2:], types, (8, 8),
                              4, 0.01)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        wattn.fused_hab_block(args[0], args[1].cpu(), *args[2:], types, (8, 8), 4, 0.01)
    q = _r(gen, 1, 32, 32, 24)
    with pytest.raises(ValueError, match="multiple of the"):
        wattn.fused_overlap_attention(q[:, :30].contiguous(), q[:, :30].contiguous(),
                                      q[:, :30].contiguous(), _r(gen, 24, 24), _r(gen, 24),
                                      _r(gen, 4, 64, 144), 8, 4, 4)
    with pytest.raises(ValueError, match="multiple of 4"):
        wattn.fused_residual_ln_mlp(_r(gen, 4, 4, 18), _r(gen, 4, 4, 18), _r(gen, 18),
                                    _r(gen, 18), _r(gen, 18, 36), _r(gen, 36), _r(gen, 36, 18),
                                    _r(gen, 18))
    with pytest.raises(ValueError, match="contiguous"):
        wattn.fused_residual_ln_mlp(_r(gen, 4, 20, 4).transpose(1, 2), _r(gen, 4, 4, 20),
                                    _r(gen, 20), _r(gen, 20), _r(gen, 20, 40), _r(gen, 40),
                                    _r(gen, 40, 20), _r(gen, 20))
    x = _r(gen, 1, 8, 8, 12)
    cargs = (_r(gen, 12), _r(gen, 12), _r(gen, 3, 3, 12, 4), _r(gen, 4), _r(gen, 3, 3, 4, 12),
             _r(gen, 12))
    with pytest.raises(ValueError, match="out_shift"):
        cab.cab_chain(x, *cargs, out_shift=8)
    with pytest.raises(ValueError, match="float32"):
        cab.cab_chain(x.double(), *cargs)
    with pytest.raises(ValueError, match="expected shape"):
        cab.cab_chain(x, cargs[0], cargs[1], _r(gen, 3, 3, 12, 5), *cargs[3:])


@pytest.mark.parametrize("kernel", ["fused_sgfn_tail", "fused_hab_block",
                                    "fused_residual_ln_mlp"])
@pytest.mark.parametrize("c", [256, 384])
def test_row_kernels_compute_above_192_channels(gen, kernel, c):
    """B6, B8 and B10 above the 192 rows that a row product stages at a time: the LayerNorm
    (fc1) and the projection (proj) take C in pieces (128 + 128 at 256, 192 + 192 at 384).
    B8 at 8 and 12 heads of 32, shifted; B6 at hidden 2C (hidden/2 = C, up to its 384)."""
    if kernel == "fused_sgfn_tail":
        args = _sgfn_args(gen, 2, 13, 21, c, 2 * c)
        got, want = sgfn.fused_sgfn_tail(*args), sgfn.fused_sgfn_tail_plain(*args)
    elif kernel == "fused_hab_block":
        heads = c // 32
        args = _hab_args(gen, 2, 16, 16, c, heads, 8, 2 * c)
        types = torch.from_numpy(windows.shift_mask_types(8, 8, 4, 4).copy()).cuda()
        kw = dict(cab_scale=_r(gen, 2, 1, 1, c, std=0.2, mean=0.5), in_shift=4)
        got = wattn.fused_hab_block(*args, types, (8, 8), heads, 0.01, **kw)
        want = wattn.fused_hab_block_plain(*args, types, (8, 8), heads, 0.01, **kw)
    else:
        args = (_r(gen, 3, 7, 11, c), _r(gen, 3, 7, 11, c), _r(gen, c, std=0.1, mean=1.0),
                _r(gen, c, std=0.1), _r(gen, c, 2 * c, std=c ** -0.5), _r(gen, 2 * c, std=0.1),
                _r(gen, 2 * c, c, std=(2 * c) ** -0.5), _r(gen, c, std=0.1))
        got = wattn.fused_residual_ln_mlp(*args)
        want = wattn.fused_residual_ln_mlp_plain(*args)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("c,hidden", [(256, 776), (200, 800), (384, 1536)])
def test_sgfn_tail_takes_hidden_rows_above_384(gen, c, hidden):
    """B6's LN_sg above hidden/2 = 384, where a hidden row no longer fits a warp's registers:
    its statistics first, then the row normalised in place."""
    args = _sgfn_args(gen, 2, 9, 13, c, hidden)
    torch.testing.assert_close(sgfn.fused_sgfn_tail(*args), sgfn.fused_sgfn_tail_plain(*args),
                               atol=1e-4, rtol=0)


def test_row_kernels_raise_above_their_limits(gen):
    """What the row kernels still refuse, with a ValueError before any launch: B8's
    attention heads of at most 32 (a HAB sends wider ones to B14)."""
    with pytest.raises(ValueError, match="whole heads up to 32"):
        wattn.fused_hab_block(*_hab_args(gen, 1, 8, 8, 256, 4, 8, 512), None, (8, 8), 4, 0.01)


@pytest.mark.parametrize("kernel", ["fused_sgfn_tail", "fused_residual_ln_mlp"])
def test_row_kernels_take_weight_views(gen, kernel):
    """The models pass their Linear weights as views (linear.weight.t()): the wrappers lay
    them out once (_mma.planes) and match the plain version on them, again after the weight
    changes in place."""
    c, hid = 64, 128
    if kernel == "fused_sgfn_tail":
        args = list(_sgfn_args(gen, 1, 8, 16, c, hid))
        slots, fn, plain = (4, 10), sgfn.fused_sgfn_tail, sgfn.fused_sgfn_tail_plain
    else:
        args = [_r(gen, 1, 8, 16, c), _r(gen, 1, 8, 16, c), _r(gen, c), _r(gen, c),
                _r(gen, c, hid, std=c ** -0.5), _r(gen, hid, std=0.1),
                _r(gen, hid, c, std=hid ** -0.5), _r(gen, c, std=0.1)]
        slots, fn, plain = (4, 6), wattn.fused_residual_ln_mlp, wattn.fused_residual_ln_mlp_plain
    for i in slots:
        args[i] = args[i].t().contiguous().t()
        assert not args[i].is_contiguous()
    for _ in range(2):
        torch.testing.assert_close(fn(*args), plain(*args), atol=1e-4, rtol=0)
        args[slots[0]].mul_(0.5)


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = torch.randn(1, 8, 8, 3, generator=gen, device="cuda")
    w, b = torch.zeros(3, 3, 3, 4, device="cuda"), torch.zeros(4, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        conv3x3.conv3x3_dense(x.double(), w.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3.conv3x3_dense(x.transpose(1, 2), w, b)
    p = _block_params(38, gen)
    with pytest.raises(ValueError, match="multiple of 4"):
        nafblock.fused_naf_block(torch.zeros(1, 8, 8, 38, device="cuda"), p)


def _mha_args(gen, b, h, w, t, d):
    return (_r(gen, b, h, w, t, d, std=0.6), _r(gen, d, 3 * d, std=d ** -0.5),
            _r(gen, 3 * d, std=0.1), _r(gen, d, d, std=d ** -0.5), _r(gen, d, std=0.1),
            _r(gen, d, std=0.1, mean=1.0), _r(gen, d, std=0.1))


@pytest.mark.parametrize("b,h,w,t,d,heads", [
    (2, 8, 16, 9, 64, 4), (1, 4, 8, 3, 32, 2), (2, 37, 45, 9, 64, 4), (1, 5, 7, 7, 48, 6),
    (1, 9, 9, 16, 64, 2), (1, 3, 3, 128, 16, 1), (1, 9, 9, 9, 96, 4), (1, 9, 9, 9, 128, 4),
    (1, 9, 9, 5, 128, 2), (1, 6, 7, 9, 64, 16), (1, 6, 7, 9, 64, 8), (1, 4, 5, 64, 128, 8),
    (2, 11, 13, 3, 80, 5), (1, 13, 17, 9, 112, 4), (1, 5, 5, 9, 96, 2),
    (1, 4, 4, 3, 144, 8), (1, 6, 7, 9, 144, 4), (1, 5, 6, 9, 256, 4), (1, 5, 6, 9, 192, 2),
    (1, 4, 4, 3, 48, 8), (1, 5, 6, 9, 96, 1), (1, 2, 2, 65, 96, 4), (1, 3, 3, 33, 192, 4),
    (1, 5, 6, 9, 100, 4), (1, 5, 6, 9, 6, 2), (1, 4, 5, 9, 384, 4), (1, 4, 5, 9, 400, 4),
    (1, 3, 4, 9, 512, 4), (1, 3, 5, 65, 128, 4), (1, 3, 4, 129, 64, 4), (1, 2, 3, 3, 400, 5)])
def test_band_mha_kernel_matches_plain(gen, b, h, w, t, d, heads):
    """B11 at the head's shape and at every width C11 listed: D above 128 (144, 192, 256,
    384), heads of 6 (padded to 8), 96 and 192 wide, 65 tokens at D = 96, 33 at D = 192, and
    D that is not a multiple of 16 (100 in heads of 25, 6 in heads of 3); and what C14
    listed, on the wide route: D = 400 and 512, 65 tokens at D = 128, 129 at D = 64, heads of
    80."""
    args = _mha_args(gen, b, h, w, t, d)
    n0 = bandmha.launches["fused_band_mha"]
    torch.testing.assert_close(bandmha.fused_band_mha(*args, heads),
                               bandmha.fused_band_mha_plain(*args, heads), atol=1e-4, rtol=0)
    assert bandmha.launches["fused_band_mha"] == n0 + 1


@pytest.mark.parametrize("b,h,w,t,d,heads", [(1, 352, 512, 9, 64, 4), (1, 32, 48, 9, 96, 4),
                                             (1, 32, 48, 9, 128, 4), (1, 32, 48, 5, 128, 2),
                                             (1, 16, 24, 9, 256, 4)])
def test_band_mha_is_f32_exact(gen, b, h, w, t, d, heads):
    """B11 at the head's served shape and at wider tokens (weights resident in shared memory
    up to D = 64, read from device memory above), the output projection scaled x100."""
    args = list(_mha_args(gen, b, h, w, t, d))
    args[3] = 100 * args[3]
    ref = bandmha.fused_band_mha_plain(*[a.double() for a in args], heads)
    _exactness(bandmha.fused_band_mha(*args, heads), bandmha.fused_band_mha_plain(*args, heads),
               ref, _tf32(bandmha.fused_band_mha_plain, *args, heads))


def test_band_mha_kernel_raises_on_what_it_does_not_take(gen):
    with pytest.raises(ValueError, match="whole number"):
        bandmha.fused_band_mha(*_mha_args(gen, 1, 2, 2, 3, 48), 5)
    args = _mha_args(gen, 1, 4, 4, 3, 64)
    with pytest.raises(ValueError, match="contiguous"):
        bandmha.fused_band_mha(args[0].transpose(1, 2), *args[1:], 4)
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        bandmha.fused_band_mha(*args, 4)


def _lka_args(gen, b, h, w, c):
    return (_r(gen, b, h, w, c), _r(gen, 5, 5, c, std=0.2), _r(gen, 21, c, std=0.2),
            _r(gen, 21, c, std=0.2), _r(gen, c, c, std=c ** -0.5),
            _r(gen, c, std=0.2, mean=1.0), _r(gen, c, std=0.1))


@pytest.mark.parametrize("b,h,w,c", [
    (2, 24, 32, 64), (1, 21, 16, 32), (3, 16, 24, 128), (9, 12, 16, 64), (1, 10, 40, 64),
    (2, 37, 45, 64), (1, 33, 40, 180), (1, 1, 1, 4), (1, 70, 5, 20), (1, 20, 30, 6),
    (2, 19, 47, 130), (1, 23, 29, 400), (1, 3, 5, 7), (2, 130, 100, 64), (1, 9, 11, 1000),
    (1, 5, 6, 1808), (1, 32, 48, 1816), (1, 32, 48, 2048), (1, 3, 5, 1810)])
def test_lka_gate_kernel_matches_plain(gen, b, h, w, c):
    """B12 at the head's width, ragged and tiny images (the chain's segments and strips end
    inside them), and at any C: 6, 7, 130, 180, 400, 1000 (tiles of 16 rows), 1808 (x read
    from device memory in the product's epilogue), and 1810, 1816 and 2048 (`a` read from
    device memory too, K in chunks with the sums in registers)."""
    args = _lka_args(gen, b, h, w, c)
    n0 = lka.launches["lka_gate"]
    torch.testing.assert_close(lka.lka_gate(*args), lka.lka_gate_plain(*args),
                               atol=1e-4, rtol=0)
    assert lka.launches["lka_gate"] == n0 + 1


def test_lka_gate_is_f32_exact(gen):
    """B12's 1x1 product on the tensor cores at the head's width, wp scaled x100."""
    args = list(_lka_args(gen, 2, 40, 56, 64))
    args[4] = 100 * args[4]
    args[5] = 0.01 * args[5]   # keeps the gate off the sigmoid's flat ends
    ref = lka.lka_gate_plain(*[a.double() for a in args])
    _exactness(lka.lka_gate(*args), lka.lka_gate_plain(*args), ref,
               _tf32(lka.lka_gate_plain, *args))


def test_lka_gate_kernel_raises_on_what_it_does_not_take(gen):
    args = _lka_args(gen, 1, 8, 8, 16)
    with pytest.raises(ValueError, match="contiguous"):
        lka.lka_gate(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        lka.lka_gate(args[0], args[1], args[2][:20], *args[3:])
    args[4].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        lka.lka_gate(*args)


def test_small_fusion_head_on_the_card(gen):
    """The shipped head on a 48x64 LR image: the kernel path against the plain path, one
    launch of B11 and of B12."""
    torch.manual_seed(0)
    head = FusionHead(FusionConfig()).cuda().eval()
    with torch.no_grad():
        for p in head.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen, device="cuda"))
    lr = torch.rand(1, 48, 64, 3, generator=gen, device="cuda")
    outs = {n: torch.rand(1, 192, 256, 3, generator=gen, device="cuda")
            for n in ("hat", "dat", "nafnet")}
    n0 = (bandmha.launches["fused_band_mha"], lka.launches["lka_gate"])
    with torch.inference_mode():
        got = head(lr, outs)
        for m in head.modules():
            if hasattr(m, "kernels"):
                m.kernels = False
        want = head(lr, outs)
    assert (bandmha.launches["fused_band_mha"], lka.launches["lka_gate"]) == (n0[0] + 1, n0[1] + 1)
    assert got.shape == (1, 192, 256, 3)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


# ---- bf16 (FREQFUSION_DTYPE=bfloat16): every kernel's bf16 instantiation against its plain
# bf16 version (max |Δ| <= 1e-2 x max|plain|) and against a float64 evaluation of the same
# bf16 inputs (at most twice the plain bf16 version's distance)

def _bf16_cases(gen):
    def r(*shape, std=1.0, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen, device="cuda")

    c, hid, half = 180, 720, 360
    p, p128 = _block_params(64, gen), _block_params(128, gen)
    stage_b = ("w3", "b3", "beta", "ln2_w", "ln2_b", "w4", "b4", "w5", "b5", "gamma")
    x64 = r(2, 37, 45, 64)
    types = torch.from_numpy(windows.shift_mask_types(16, 16, 8, 8).copy()).cuda()
    hab = (r(1, 32, 48, c), r(1, 32, 48, c, std=3.0), r(c, std=0.1, mean=1.0), r(c, std=0.1),
           r(c, std=0.1, mean=1.0), r(c, std=0.1), r(c, 3 * c, std=c ** -0.5), r(3 * c, std=0.1),
           r(c, c, std=c ** -0.5), r(c, std=0.1), r(c, 360, std=c ** -0.5), r(360, std=0.1),
           r(360, c, std=360 ** -0.5), r(c, std=0.1), r(6, 256, 256, std=0.5))
    return {
        "naf_block_stage_a": (nafblock.naf_block_stage_a, nafblock.naf_block_stage_a_plain,
                              (x64, p["ln1_w"], p["ln1_b"], p["w1"], p["b1"], p["wdw"],
                               p["bdw"]), {}),
        "naf_block_stage_b": (nafblock.naf_block_stage_b, nafblock.naf_block_stage_b_plain,
                              (r(2, 37, 45, 64), x64, r(2, 64), *(p[k] for k in stage_b)),
                              {}),
        "naf_block_stage_b_c128": (nafblock.naf_block_stage_b, nafblock.naf_block_stage_b_plain,
                                   (r(1, 19, 23, 128), r(1, 19, 23, 128), r(1, 128),
                                    *(p128[k] for k in stage_b)), {}),
        "conv3x3_narrow": (conv3x3.conv3x3_dense, conv3x3.conv3x3_dense_plain,
                           (r(1, 37, 45, 3), r(3, 3, 3, 64, std=0.2), r(64, std=0.1)), {}),
        "conv3x3_wide": (conv3x3.conv3x3_dense, conv3x3.conv3x3_dense_plain,
                         (r(2, 37, 45, c), r(3, 3, c, c, std=(9 * c) ** -0.5), r(c, std=0.1)),
                         {}),
        "xqkv": (wattn.fused_window_attention_xqkv, wattn.fused_window_attention_xqkv_plain,
                 (r(2, 32, 64, c), r(c, 270, std=c ** -0.5), r(270, std=0.1),
                  r(3, 256, 256, std=0.5), None, (8, 32), 3), {}),
        "aim_conv_branch": (aim.aim_conv_branch, aim.aim_conv_branch_plain,
                            (r(2, 37, 45, c), r(3, 3, 1, c, std=1 / 3), r(c, std=0.1),
                             r(c, std=0.2, mean=1.0), r(c, std=0.1)), {}),
        "aim_gates_proj": (aim.aim_gates_proj, aim.aim_gates_proj_plain,
                           (r(2, 37, 45, c), r(2, 37, 45, c), r(2, 1, 1, c),
                            r(1, 1, c, 11, std=c ** -0.5), r(11, std=0.1),
                            r(11, std=0.2, mean=1.0), r(11, std=0.1),
                            r(1, 1, 11, 1, std=0.3), r(1, std=0.1), r(c, c, std=c ** -0.5),
                            r(c, std=0.1)), {"swap": True}),
        "sgfn": (sgfn.fused_sgfn_tail, sgfn.fused_sgfn_tail_plain,
                 (r(2, 37, 45, c), r(2, 37, 45, c), r(c, std=0.1, mean=1.0), r(c, std=0.1),
                  r(c, hid, std=c ** -0.5), r(hid, std=0.1), r(half, std=0.1, mean=1.0),
                  r(half, std=0.1), r(3, 3, 1, half, std=1 / 3), r(half, std=0.1),
                  r(half, c, std=half ** -0.5), r(c, std=0.1)), {}),
        "cab_chain": (cab.cab_chain, cab.cab_chain_plain,
                      (r(1, 32, 64, c), r(c, std=0.1, mean=1.0), r(c, std=0.1),
                       r(3, 3, c, 60, std=(9 * c) ** -0.5), r(60, std=0.1),
                       r(3, 3, 60, c, std=(540) ** -0.5), r(c, std=0.1)), {"out_shift": 8}),
        "hab_block": (wattn.fused_hab_block, wattn.fused_hab_block_plain,
                      hab + (types, (16, 16), 6, 0.01),
                      {"cab_scale": r(1, 1, 1, c, std=0.2, mean=0.5), "in_shift": 8}),
        "overlap": (wattn.fused_overlap_attention, wattn.fused_overlap_attention_plain,
                    (r(1, 32, 48, c), r(1, 32, 48, c), r(1, 32, 48, c), r(c, c, std=c ** -0.5),
                     r(c, std=0.1), r(6, 256, 576, std=0.5), 16, 8, 6), {}),
        "residual_mlp": (wattn.fused_residual_ln_mlp, wattn.fused_residual_ln_mlp_plain,
                         (r(2, 37, 45, c), r(2, 37, 45, c), r(c, std=0.1, mean=1.0),
                          r(c, std=0.1), r(c, 360, std=c ** -0.5), r(360, std=0.1),
                          r(360, c, std=360 ** -0.5), r(c, std=0.1)), {}),
        "band_mha": (bandmha.fused_band_mha, bandmha.fused_band_mha_plain,
                     (r(2, 17, 23, 9, 64, std=0.6), r(64, 192, std=0.125), r(192, std=0.1),
                      r(64, 64, std=0.125), r(64, std=0.1), r(64, std=0.1, mean=1.0),
                      r(64, std=0.1), 4), {}),
        "lka_gate": (lka.lka_gate, lka.lka_gate_plain,
                     (r(3, 37, 45, 64), r(5, 5, 64, std=0.2), r(21, 64, std=0.2),
                      r(21, 64, std=0.2), r(64, 64, std=0.125), r(64, std=0.2, mean=1.0),
                      r(64, std=0.1)), {}),
        "wattn_qkv": (wattn.fused_window_attention_qkv, wattn.fused_window_attention_qkv_plain,
                      (r(2, 24, 40, 96), r(2, 24, 40, 96), r(2, 24, 40, 96),
                       r(2, 64, 64, std=0.5), None, (8, 8), 2), {}),
        "window_attention": (wattn.fused_window_attention, wattn.fused_window_attention_plain,
                             (r(1, 30, 45, c), r(c, 3 * c, std=c ** -0.5), r(3 * c, std=0.1),
                              r(c, c, std=c ** -0.5), r(c, std=0.1), r(6, 225, 225, std=0.5),
                              None, (15, 15), 6), {}),
    }


BF16_CASES = ["naf_block_stage_a", "naf_block_stage_b", "naf_block_stage_b_c128",
              "conv3x3_narrow", "conv3x3_wide", "xqkv", "aim_conv_branch", "aim_gates_proj",
              "sgfn", "cab_chain", "hab_block", "overlap", "residual_mlp", "band_mha",
              "lka_gate", "wattn_qkv", "window_attention"]


def _as(t, dtype):
    return t.to(dtype) if isinstance(t, torch.Tensor) and t.is_floating_point() else t


@pytest.mark.parametrize("case", BF16_CASES)
def test_kernel_at_bf16_matches_plain_and_float64(gen, case):
    kernel, plain, args, kw = _bf16_cases(gen)[case]
    a16 = [_as(t, torch.bfloat16) for t in args]
    k16 = {k: _as(v, torch.bfloat16) for k, v in kw.items()}
    with torch.inference_mode():
        got, want = kernel(*a16, **k16), plain(*a16, **k16)
        ref = plain(*(_as(t, torch.float64) for t in a16),
                    **{k: _as(v, torch.float64) for k, v in k16.items()})
    g, w, f = (o[0] if isinstance(o, tuple) else o for o in (got, want, ref))
    assert g.dtype == w.dtype == torch.bfloat16
    assert (g.float() - w.float()).abs().max() <= 1e-2 * w.float().abs().max()
    assert (g.double() - f).abs().max() <= 2 * (w.double() - f).abs().max()
    if isinstance(got, tuple):   # the f32 channel sums
        assert got[1].dtype == torch.float32
        denom = w.float().abs().sum((1, 2)).reshape(got[1].shape)
        assert ((got[1] - want[1]).abs() <= 1e-3 * denom).all()


def test_kernels_refuse_float16_and_mixed_dtypes_on_the_card(gen):
    x = torch.randn(1, 16, 16, 32, generator=gen, device="cuda")
    w, b = torch.randn(3, 3, 32, 32, device="cuda"), torch.randn(32, device="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv3x3.conv3x3_dense(x.half(), w.half(), b.half())
    with pytest.raises(ValueError, match="one dtype"):
        conv3x3.conv3x3_dense(x.bfloat16(), w, b)
    # the wide route, once f32 only, serves bf16 (its scratch and residual in f32)
    args = [torch.randn(1, 2, 2, 9, 512, generator=gen, device="cuda").bfloat16()] + [
        t.bfloat16() for t in (torch.randn(512, 1536, generator=gen, device="cuda") / 23,
                               torch.randn(1536, generator=gen, device="cuda"),
                               torch.randn(512, 512, generator=gen, device="cuda") / 23,
                               torch.randn(512, generator=gen, device="cuda"),
                               torch.ones(512, device="cuda"), torch.zeros(512, device="cuda"))]
    with torch.inference_mode():
        got = bandmha.fused_band_mha(*args, 8)
        want = bandmha.fused_band_mha_plain(*args, 8)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()


@pytest.mark.parametrize("case", BF16_CASES)
def test_kernel_at_precision_default_matches_plain(gen, case):
    """Precision "default" (f32 storage, bf16 operands): each kernel's default instantiation
    against its plain default version on the same f32 inputs within 1e-2 x max|plain|, at
    most twice that version's distance from float64, and an RMS distance from it at most a
    quarter of the plain default version's RMS distance from the plain f32 one (a kernel that
    skipped the rounding sits at that distance). B5a has no product: its f32 path."""
    from freqfusion_tpu_torch.ops.kernels import _mma
    kernel, plain, args, kw = _bf16_cases(gen)[case]
    with torch.inference_mode():
        with _mma.operands(torch.bfloat16):
            got, want = kernel(*args, **kw), plain(*args, **kw)
        want32 = plain(*args, **kw)
        ref = plain(*(_as(t, torch.float64) for t in args),
                    **{k: _as(v, torch.float64) for k, v in kw.items()})
    g, w, w32, f = (o[0] if isinstance(o, tuple) else o for o in (got, want, want32, ref))
    assert g.dtype == w.dtype == torch.float32
    assert (g - w).abs().max() <= 1e-2 * w.abs().max()
    assert (g.double() - f).abs().max() <= 2 * (w.double() - f).abs().max()
    if case != "aim_conv_branch":
        rms = lambda a, b: (a.double() - b.double()).pow(2).mean().sqrt()   # noqa: E731
        assert rms(g, w) <= 0.25 * rms(w, w32)


def test_two_gloo_ranks_sharing_the_card_step_as_one_process(gen):
    """Two gloo ranks on the one card (``parallel/mesh.py``: collectives through host
    copies) against one process at the same global batch of 4: two cached steps of a small
    head in float64 with dropout and BatchNorm on, held as on the CPU
    (``tests/test_torch_parallel.py``: 1e-5 relative, 1e-5 x each leaf's max|g|, 1e-6)."""
    import torch_parallel_ranks as ranks
    from freqfusion_tpu_torch.parallel.mesh import run_ranks

    torch.manual_seed(3)
    state = ranks.double(FusionHead(FusionConfig(**ranks.TINY)).state_dict())
    batches = [ranks.head_batch(16, 16, 10), ranks.head_batch(16, 16, 20)]
    two = run_ranks(ranks.cached_steps, 2, 2, ranks.TINY, state, batches, 1e-3, True, 0,
                    torch.float64, "cuda", timeout_s=300)
    one = ranks.cached_steps(0, 1, ranks.TINY, state, batches, 1e-3, True, 0, torch.float64,
                             "cuda")
    ranks.hold(one, two)


def test_serving_on_every_card_present(gen):
    """InferencePipeline(n_devices=None: every card) with the kernels: a tile batch and a
    whole-image group split over the cards' replicas, within 1e-4 of one card."""
    import copy
    import torch_parallel_ranks as ranks
    from freqfusion_tpu_torch.infer.io import InferencePipeline
    from freqfusion_tpu_torch.models.experts import FreqFusionSR

    n = torch.cuda.device_count()
    torch.manual_seed(11)
    ref = FreqFusionSR(FusionConfig(**ranks.TINY), **ranks.LIVE_EXPERTS)
    one = InferencePipeline(copy.deepcopy(ref), "cuda:0", tile=32, overlap=8, tile_batch=2)
    every = InferencePipeline(ref, "cuda", tile=32, overlap=8, tile_batch=2)
    assert every.n_devices == n and every.tile_batch % n == 0
    rng = np.random.default_rng(12)
    x = rng.uniform(size=(2 * n, 32, 32, 3)).astype(np.float32)
    got, want = every.forward_batch(x), one.forward_batch(x)
    assert got.device == torch.device("cuda", 0)
    assert float((got - want).abs().max()) <= 1e-4
    lrs = [rng.uniform(size=(40, 50, 3)).astype(np.float32) for _ in range(max(n - 1, 1))]
    for a, out in zip(lrs, every.materialize_u8(every.dispatch_batch_u8(lrs))):
        w = one.materialize_u8(one.dispatch_batch_u8([a]))[0]
        assert np.abs(out.astype(np.int32) - w.astype(np.int32)).max() <= 1
