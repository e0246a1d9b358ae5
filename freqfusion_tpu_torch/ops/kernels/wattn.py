"""Window attention kernels and their plain versions: DAT's rectangular-window attention
with the qkv projection fused in (B4) and from pre-projected images (B13), and HAT's fused
HAB block (B8), overlapping cross-attention (B9), residual + LayerNorm + MLP tail (B10) and
standalone window attention with both projections (B14).

Twins of ``freqfusion_tpu/ops/pallas/wattn.py``'s ``fused_window_attention_xqkv``,
``fused_window_attention_qkv``, ``fused_hab_block``, ``fused_overlap_attention``,
``fused_residual_ln_mlp`` and ``fused_window_attention``. On a CUDA tensor a wrapper
launches its kernels (``csrc/wattn.cu``, ``csrc/hab_attention.cu``, ``csrc/oca.cu``,
``csrc/hat_rows.cu``) or raises; on a CPU tensor it runs the plain PyTorch version. There is
no fallback from one to the other. B8's attention and every row product (B8's tail, B9's
projection, B10, B14's projections) run f32-exact on the tensor cores (3xTF32); their
weights are zero-padded to multiples of 8, the MMA's k and n.
Dense weights come as [in,out] matrices of x @ w, as in the JAX package; every LayerNorm
uses eps 1e-5.

B4's layouts (NHWC, f32): x [B,H,W,Cin]; wqkv [Cin, 3*co] and bqkv [3*co], one branch's q, k, v
columns (co = num_heads * head_dim); bias [num_heads, N, N] with N = window tokens; mask
None, the numpy shift mask [nW, N, N] of ``ops.windows.shift_attn_mask`` or its 4 window
types as a tensor [4, N, N] (see ``mask_types``). The result is
the co-wide attended image [B,H,W,co], before any output projection. The caller rolls x
before and the result after a shifted block; nothing here shifts. B13 takes the same bias
and mask with q, k, v [B,H,W,C] projected (and zero-padded to whole windows) by the caller;
B14 takes x [B,H,W,C] with the whole [C,3C] projection and the [C,C] output projection.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..common import layernorm
from ..windows import extract_overlapping_windows, window_partition, window_reverse
from . import _build

#: Kernel launches since the last reset. Plain runs are not counted.
launches = {"fused_window_attention_xqkv": 0, "fused_hab_block": 0,
            "fused_overlap_attention": 0, "fused_residual_ln_mlp": 0,
            "fused_window_attention_qkv": 0, "fused_window_attention": 0}

#: What csrc/oca.cu takes: at most 576 keys (a 16-px window grown to 24 px) per window.
MAX_OCA_KEYS = 576

#: What csrc/wattn.cu takes: windows of 64, 128, 192 or 256 tokens, heads up to 32 wide.
MAX_TOKENS = 256
MAX_HEAD_DIM = 32
#: What csrc/wattn.cu's pre-projected kernel takes: windows of any size up to 576 tokens.
MAX_QKV_TOKENS = 576
_SLOT = 32               # columns of one head's q, k or v in the padded weight


def mask_types(mask, n_wr: int, n_wc: int, device) -> torch.Tensor:
    """The shift mask reduced to its 4 window types [4,N,N] on `device`: 0 interior,
    1 last column, 2 last row, 3 corner. `mask` is the numpy mask [nW,N,N] of the whole
    image, which is checked window by window to equal its type (the JAX package asserts
    the same, so nothing is lost), or the 4 types themselves as a tensor [4,N,N]
    (``ops.windows.shift_mask_types``), which a caller keeps to spare building and checking
    O(image) * N^2 floats on every call."""
    if isinstance(mask, torch.Tensor) and mask.dim() == 3 and mask.shape[0] == 4:
        if mask.device != torch.device(device) or mask.dtype != torch.float32:
            raise ValueError(f"mask: expected float32 window types on {device}, got "
                             f"{mask.dtype} on {mask.device}")
        return mask
    if not isinstance(mask, np.ndarray):
        raise TypeError("mask: expected a numpy array [nW,N,N] or its window types as a "
                        f"tensor [4,N,N], got {type(mask).__name__} "
                        f"{tuple(getattr(mask, 'shape', ()))}")
    n = mask.shape[-1]
    if mask.shape != (n_wr * n_wc, n, n):
        raise ValueError(f"mask: expected shape {(n_wr * n_wc, n, n)}, got {mask.shape}")
    g = mask.reshape(n_wr, n_wc, n, n)
    types = np.stack([g[0, 0], g[0, n_wc - 1], g[n_wr - 1, 0],
                      g[n_wr - 1, n_wc - 1]]).astype(np.float32)
    for i in range(n_wr):
        for j in range(n_wc):
            t = (2 if i == n_wr - 1 else 0) + (1 if j == n_wc - 1 else 0)
            if not np.array_equal(g[i, j], types[t]):
                raise ValueError(f"mask: window ({i},{j}) is not of window type {t}")
    return torch.from_numpy(types).to(device)


def _type_index(n_wr: int, n_wc: int, device) -> torch.Tensor:
    """Window type of each window in row-major order, [n_wr * n_wc] int64."""
    r = (torch.arange(n_wr, device=device) == n_wr - 1).long()
    c = (torch.arange(n_wc, device=device) == n_wc - 1).long()
    return (2 * r[:, None] + c[None, :]).reshape(-1)


def fused_window_attention_qkv_plain(q, k, v, bias, mask, window, num_heads):
    """Multi-head attention inside (hs, ws) windows of pre-projected images [B,H,W,C]:
    softmax(q k^T / sqrt(head_dim) + bias (+ mask)) v. Returns [B,H,W,C]."""
    b, h, w, c = q.shape
    hs, ws = window
    n, hd = hs * ws, c // num_heads

    def to_wins(t):  # [B*nW, heads, N, hd]
        return window_partition(t, hs, ws).reshape(-1, n, num_heads, hd).permute(0, 2, 1, 3)

    attn = (to_wins(q) * hd ** -0.5) @ to_wins(k).transpose(-1, -2) + bias[None]
    if mask is not None:
        n_wr, n_wc = h // hs, w // ws
        per_win = mask_types(mask, n_wr, n_wc, q.device)[_type_index(n_wr, n_wc, q.device)]
        attn = (attn.reshape(b, n_wr * n_wc, num_heads, n, n)
                + per_win[None, :, None]).reshape(-1, num_heads, n, n)
    out = torch.softmax(attn, dim=-1) @ to_wins(v)
    return window_reverse(out.permute(0, 2, 1, 3).reshape(-1, n, c), hs, ws, h, w)


def _launch_qkv(lib, q_ptr, k_ptr, v_ptr, ld, bias, types, out, window, num_heads, name):
    """csrc/wattn.cu's pre-projected attention into `out` [B,H,W,C]; q, k, v are device
    addresses of images with `ld` floats a pixel."""
    b, h, w, c = out.shape
    with torch.cuda.device(out.device):
        err = lib.wattn_qkv(q_ptr, k_ptr, v_ptr, bias.data_ptr(),
                            0 if types is None else types.data_ptr(), out.data_ptr(), b, h, w,
                            ld, window[0], window[1], num_heads, c // num_heads,
                            _build.stream_ptr(out.device))
    _build.check(err, name)


def _check_qkv_shape(name, h, w, c, window, num_heads):
    hs, ws = window
    if h % hs or w % ws:
        raise ValueError(f"{name}: {h}x{w} is not a multiple of the {hs}x{ws} window")
    if hs * ws > MAX_QKV_TOKENS:
        raise ValueError(f"{name}: {hs * ws} tokens per window; the kernel takes up to "
                         f"{MAX_QKV_TOKENS}")
    if c % num_heads or c // num_heads > MAX_HEAD_DIM:
        raise ValueError(f"{name}: C={c} over {num_heads} heads; the kernel takes whole "
                         f"heads up to {MAX_HEAD_DIM} wide")


def fused_window_attention_qkv(q, k, v, bias, mask, window, num_heads):
    """Kernel B13 on CUDA, its plain version on the CPU: multi-head attention inside
    (hs, ws) windows of pre-projected q, k, v [B,H,W,C], already zero-padded to whole
    windows and already rolled in a shifted block. A zero-padded key is not masked: it
    scores its bias and takes part in the softmax. Returns [B,H,W,C]."""
    name = "fused_window_attention_qkv"
    _build.require_no_grad(name, q, k, v, bias)
    if q.device.type == "cpu":
        return fused_window_attention_qkv_plain(q, k, v, bias, mask, window, num_heads)
    b, h, w, c = q.shape
    hs, ws = window
    n = hs * ws
    _check_qkv_shape(name, h, w, c, window, num_heads)
    _build.require(q, "q")
    _build.require(k, "k", q.shape)
    _build.require(v, "v", q.shape)
    _build.require(bias, "bias", (num_heads, n, n))
    types = None if mask is None else mask_types(mask, h // hs, w // ws, q.device)
    out = torch.empty_like(q)
    _launch_qkv(_build.library(), q.data_ptr(), k.data_ptr(), v.data_ptr(), c, bias, types,
                out, window, num_heads, "wattn_qkv")
    launches[name] += 1
    return out


def fused_window_attention_plain(x, wqkv, bqkv, wproj, bproj, bias, mask, window, num_heads):
    q, k, v = (x @ wqkv + bqkv).chunk(3, dim=-1)
    att = fused_window_attention_qkv_plain(q, k, v, bias, mask, window, num_heads)
    return att @ wproj + bproj


def fused_window_attention(x, wqkv, bqkv, wproj, bproj, bias, mask, window, num_heads):
    """Kernel B14 on CUDA, its plain version on the CPU: one (S)W-MSA pass over an already
    rolled image x [B,H,W,C] of any parity, qkv projection [C,3C] -> attention in
    (hs, ws) windows with bias [heads,N,N] (+ the shift mask) -> output projection [C,C].
    Returns [B,H,W,C]. Three launches: the row product of csrc/hat_rows.cu on either side
    of csrc/wattn.cu's pre-projected attention; q, k, v pass through device memory once."""
    name = "fused_window_attention"
    _build.require_no_grad(name, x, wqkv, bqkv, wproj, bproj, bias)
    if x.device.type == "cpu":
        return fused_window_attention_plain(x, wqkv, bqkv, wproj, bproj, bias, mask, window,
                                            num_heads)
    b, h, w, c = x.shape
    hs, ws = window
    n = hs * ws
    _check_qkv_shape(name, h, w, c, window, num_heads)
    if c % 4:
        raise ValueError(f"{name}: C={c} is not a multiple of 4")
    _build.require(x, "x")
    for nm, t, shape in (("wqkv", wqkv, (c, 3 * c)), ("bqkv", bqkv, (3 * c,)),
                         ("wproj", wproj, (c, c)), ("bproj", bproj, (c,)),
                         ("bias", bias, (num_heads, n, n))):
        _build.require(t, nm, shape)
    types = None if mask is None else mask_types(mask, h // hs, w // ws, x.device)
    kp, np3 = _ceil8(c), _ceil8(3 * c)
    wq, wpp = _padded_proj(wqkv, kp, np3), _padded_proj(wproj, kp, kp)
    lib = _build.library()
    qkv = torch.empty((b, h, w, 3 * c), device=x.device, dtype=torch.float32)
    att = torch.empty_like(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = _build.stream_ptr(x.device)
        err = lib.rows_linear(x.data_ptr(), wq.data_ptr(), bqkv.data_ptr(), qkv.data_ptr(),
                              b * h * w, c, 3 * c, kp, np3, stream)
        _build.check(err, "rows_linear")
        p = qkv.data_ptr()
        _launch_qkv(lib, p, p + 4 * c, p + 8 * c, 3 * c, bias, types, att, window, num_heads,
                    "wattn_qkv")
        err = lib.rows_linear(att.data_ptr(), wpp.data_ptr(), bproj.data_ptr(),
                              out.data_ptr(), b * h * w, c, c, kp, kp, stream)
    _build.check(err, "rows_linear")
    launches[name] += 1
    return out


def fused_window_attention_xqkv_plain(x, wqkv, bqkv, bias, mask, window, num_heads):
    """Project this branch's q, k, v from x, then fused_window_attention_qkv_plain."""
    q, k, v = (x @ wqkv + bqkv).chunk(3, dim=-1)
    return fused_window_attention_qkv_plain(q, k, v, bias, mask, window, num_heads)


def _padded_head_weights(wqkv, bqkv, num_heads: int, hd: int, kp: int, slots: int = 4):
    """wqkv [Cin,3*co] -> [heads, kp, 32 * slots] with head h's q, k, v in columns 0..,
    32.., 64.. (zeros elsewhere, rows Cin..kp zero too), and bqkv -> [heads, 32 * slots]
    likewise; padded zeros change nothing. B4's streamed product takes N in steps of 64,
    hence 4 slots (q | k | v | zeros) and kp a multiple of 16; B8's attention takes the
    3 slots q | k | v and kp a multiple of 8."""
    cin = wqkv.shape[0]
    wh = wqkv.new_zeros(num_heads, kp, slots, _SLOT)
    wh[:, :cin, :3, :hd] = wqkv.reshape(cin, 3, num_heads, hd).permute(2, 0, 1, 3)
    bh = bqkv.new_zeros(num_heads, slots, _SLOT)
    bh[:, :3, :hd] = bqkv.reshape(3, num_heads, hd).permute(1, 0, 2)
    return wh.reshape(num_heads, kp, slots * _SLOT), bh.reshape(num_heads, slots * _SLOT)


def fused_window_attention_xqkv(x, wqkv, bqkv, bias, mask, window, num_heads):
    """Kernel B4 on CUDA, its plain version on the CPU. Returns [B,H,W,co]."""
    _build.require_no_grad("fused_window_attention_xqkv", x, wqkv, bqkv, bias)
    if x.device.type == "cpu":
        return fused_window_attention_xqkv_plain(x, wqkv, bqkv, bias, mask, window,
                                                 num_heads)
    b, h, w, cin = x.shape
    hs, ws = window
    n = hs * ws
    co = wqkv.shape[1] // 3
    hd = co // num_heads
    if h % hs or w % ws:
        raise ValueError(f"fused_window_attention_xqkv: {h}x{w} is not a multiple of the "
                         f"{hs}x{ws} window")
    if n % 64 or n > MAX_TOKENS:
        raise ValueError(f"fused_window_attention_xqkv: {n} tokens per window; the kernel "
                         f"takes multiples of 64 up to {MAX_TOKENS}")
    if hd * num_heads != co or hd > MAX_HEAD_DIM:
        raise ValueError(f"fused_window_attention_xqkv: {co} columns over {num_heads} heads; "
                         f"the kernel takes whole heads up to {MAX_HEAD_DIM} wide")
    if cin % 4:
        raise ValueError(f"fused_window_attention_xqkv: Cin={cin} is not a multiple of 4")
    _build.require(x, "x")
    _build.require(wqkv, "wqkv", (cin, 3 * co))
    _build.require(bqkv, "bqkv", (3 * co,))
    _build.require(bias, "bias", (num_heads, n, n))
    n_wr, n_wc = h // hs, w // ws
    types = None if mask is None else mask_types(mask, n_wr, n_wc, x.device)
    kp = -(-cin // 16) * 16
    wh, bh = _padded_head_weights(wqkv, bqkv, num_heads, hd, kp)
    lib = _build.library()
    out = torch.empty((b, h, w, co), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.wattn_xqkv(x.data_ptr(), wh.data_ptr(), bh.data_ptr(), bias.data_ptr(),
                             0 if types is None else types.data_ptr(), out.data_ptr(),
                             b, h, w, cin, kp, hs, ws, num_heads, hd,
                             _build.stream_ptr(x.device))
    _build.check(err, "wattn_xqkv")
    launches["fused_window_attention_xqkv"] += 1
    return out


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _mlp_padded_weights(c: int, w1, w2):
    """(kp, npad, k2p, w1p [kp,k2p], w2p [k2p,npad]) for an MLP on C-wide rows: the row
    products take K and N in multiples of 8, and the hidden, fc1's N and fc2's K, passes
    through a buffer k2p wide; padded zeros change nothing."""
    hid = w1.shape[1]
    kp, k2p = _ceil8(c), _ceil8(hid)
    return (kp, kp, k2p, F.pad(w1, (0, k2p - hid, 0, kp - c)),
            F.pad(w2, (0, kp - c, 0, k2p - hid)))


def _padded_proj(w, kp: int, npad: int):
    """w [K,N] zero-padded to [kp,npad], multiples of 8 for the row products."""
    return F.pad(w, (0, npad - w.shape[1], 0, kp - w.shape[0]))


def _mlp_plain(y, ln_w, ln_b, w1, b1, w2, b2):
    return y + F.gelu(layernorm(y, ln_w, ln_b) @ w1 + b1) @ w2 + b2


def fused_hab_block_plain(x, conv_x, ln1_w, ln1_b, ln2_w, ln2_b, wqkv, bqkv, wproj, bproj,
                          w1, b1, w2, b2, bias, mask, window, num_heads, conv_scale,
                          cab_scale=None, in_shift: int = 0):
    xs = torch.roll(x, (-in_shift, -in_shift), dims=(1, 2)) if in_shift else x
    q, k, v = (layernorm(xs, ln1_w, ln1_b) @ wqkv + bqkv).chunk(3, dim=-1)
    att = fused_window_attention_qkv_plain(q, k, v, bias, mask, window, num_heads)
    cx = conv_x if cab_scale is None else conv_x * cab_scale
    y = xs + att @ wproj + bproj + conv_scale * cx
    return _mlp_plain(y, ln2_w, ln2_b, w1, b1, w2, b2)


def fused_hab_block(x, conv_x, ln1_w, ln1_b, ln2_w, ln2_b, wqkv, bqkv, wproj, bproj, w1, b1,
                    w2, b2, bias, mask, window, num_heads, conv_scale, cab_scale=None,
                    in_shift: int = 0):
    """Kernel B8 on CUDA, its plain version on the CPU: a whole HAB without its CAB convs,

        y = x + proj(W-MSA(LN1 x)) + conv_scale * cab_scale * conv_x
        out = y + fc2(GELU(fc1(LN2 y)))                              [B,H,W,C]

    x [B,H,W,C] is the block's input and conv_x the CAB branch, both already rolled by the
    caller in a shifted block, whose `mask` is the shift mask (numpy [nW,N,N] or its 4
    window types [4,N,N], see ``mask_types``). With ``in_shift = s`` x comes un-rolled and
    each window is read at (+s, +s) with wrap-around (conv_x still comes rolled): the
    result is in rolled coordinates either way and the caller un-rolls it. cab_scale
    [B,1,1,C] is the channel-attention gate of the CAB branch."""
    _build.require_no_grad("fused_hab_block", x, conv_x, ln1_w, ln1_b, ln2_w, ln2_b, wqkv, bqkv,
                           wproj, bproj, w1, b1, w2, b2, bias,
                           *([] if cab_scale is None else [cab_scale]))
    wsh, wsw = window
    if in_shift and (mask is None or 2 * in_shift != wsh or 2 * in_shift != wsw):
        raise ValueError(f"fused_hab_block: in_shift={in_shift} needs a shift mask and a "
                         f"window of twice the shift, got {wsh}x{wsw}")
    if x.device.type == "cpu":
        return fused_hab_block_plain(x, conv_x, ln1_w, ln1_b, ln2_w, ln2_b, wqkv, bqkv, wproj,
                                     bproj, w1, b1, w2, b2, bias, mask, window, num_heads,
                                     conv_scale, cab_scale, in_shift)
    attention, tail, out = _hab_block_launchers(
        x, conv_x, ln1_w, ln1_b, ln2_w, ln2_b, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2, bias,
        mask, window, num_heads, conv_scale, cab_scale, in_shift)
    attention()
    tail()
    launches["fused_hab_block"] += 1
    return out


def _hab_block_launchers(x, conv_x, ln1_w, ln1_b, ln2_w, ln2_b, wqkv, bqkv, wproj, bproj, w1,
                         b1, w2, b2, bias, mask, window, num_heads, conv_scale, cab_scale,
                         in_shift):
    """Checks B8's CUDA arguments and lays out its weights; returns (attention, tail, out):
    two functions that each launch one half of the block on the current stream (the tail
    reads what the attention wrote) and the output they fill. ``fused_hab_block`` calls
    both; a caller may time them apart."""
    wsh, wsw = window
    b, h, w, c = x.shape
    n, hd, hid = wsh * wsw, c // num_heads, w1.shape[1]
    if wsh != wsw or h % wsh or w % wsw:
        raise ValueError(f"fused_hab_block: {h}x{w} is not a multiple of a square window, "
                         f"got {wsh}x{wsw}")
    if n % 64 or n > MAX_TOKENS:
        raise ValueError(f"fused_hab_block: {n} tokens per window; the kernel takes "
                         f"multiples of 64 up to {MAX_TOKENS}")
    if hd * num_heads != c or hd > MAX_HEAD_DIM or c % 4:
        raise ValueError(f"fused_hab_block: C={c} over {num_heads} heads; the kernel takes "
                         f"whole heads up to {MAX_HEAD_DIM} wide and C a multiple of 4")
    _build.require(x, "x")
    _build.require(conv_x, "conv_x", x.shape)
    for name, t, shape in (("ln1_w", ln1_w, (c,)), ("ln1_b", ln1_b, (c,)),
                           ("ln2_w", ln2_w, (c,)), ("ln2_b", ln2_b, (c,)),
                           ("wqkv", wqkv, (c, 3 * c)), ("bqkv", bqkv, (3 * c,)),
                           ("wproj", wproj, (c, c)), ("bproj", bproj, (c,)),
                           ("w1", w1, (c, hid)), ("b1", b1, (hid,)), ("w2", w2, (hid, c)),
                           ("b2", b2, (c,)), ("bias", bias, (num_heads, n, n))):
        _build.require(t, name, shape)
    if cab_scale is not None:
        _build.require(cab_scale, "cab_scale", (b, 1, 1, c))
    types = None if mask is None else mask_types(mask, h // wsh, w // wsw, x.device)
    kp, npad, k2p, w1p, w2p = _mlp_padded_weights(c, w1, w2)
    wh, bh = _padded_head_weights(wqkv, bqkv, num_heads, hd, kp, slots=3)
    wpp = _padded_proj(wproj, kp, npad)
    lib = _build.library()
    att = torch.empty_like(x)
    out = torch.empty_like(x)
    hidden = torch.empty((b, h, w, k2p), device=x.device, dtype=torch.float32)

    def attention():
        with torch.cuda.device(x.device):
            err = lib.hab_attention(x.data_ptr(), ln1_w.data_ptr(), ln1_b.data_ptr(),
                                    wh.data_ptr(), bh.data_ptr(), bias.data_ptr(),
                                    0 if types is None else types.data_ptr(), att.data_ptr(),
                                    b, h, w, c, kp, wsh, num_heads, hd, in_shift,
                                    _build.stream_ptr(x.device))
        _build.check(err, "hab_attention")

    def tail():
        with torch.cuda.device(x.device):
            err = lib.hab_tail(att.data_ptr(), x.data_ptr(), conv_x.data_ptr(),
                               0 if cab_scale is None else cab_scale.data_ptr(),
                               wpp.data_ptr(), bproj.data_ptr(), ln2_w.data_ptr(),
                               ln2_b.data_ptr(), w1p.data_ptr(), b1.data_ptr(), w2p.data_ptr(),
                               b2.data_ptr(), hidden.data_ptr(), out.data_ptr(), b, h, w, c,
                               hid, kp, npad, k2p, in_shift, float(conv_scale),
                               _build.stream_ptr(x.device))
        _build.check(err, "hab_tail")

    return attention, tail, out


def fused_overlap_attention_plain(q, k, v, wproj, bproj, bias, window: int, overlap: int,
                                  num_heads: int):
    b, h, w, c = q.shape
    hd = c // num_heads

    def heads(t):  # [B*nW, n, C] -> [B*nW, heads, n, hd]
        return t.reshape(t.shape[0], t.shape[1], num_heads, hd).permute(0, 2, 1, 3)

    # k and v are zero-padded after their projection: a padded key scores its bias alone
    kw = heads(extract_overlapping_windows(k, window, overlap))
    vw = heads(extract_overlapping_windows(v, window, overlap))
    attn = (heads(window_partition(q, window, window)) * hd ** -0.5) @ kw.transpose(-1, -2)
    out = torch.softmax(attn + bias[None], dim=-1) @ vw
    out = out.permute(0, 2, 1, 3).reshape(-1, window * window, c) @ wproj + bproj
    return window_reverse(out, window, window, h, w)


def fused_overlap_attention(q, k, v, wproj, bproj, bias, window: int, overlap: int,
                            num_heads: int):
    """Kernel B9 on CUDA, its plain version on the CPU: OCAB's attention of window x window
    queries over the (window + overlap)^2 keys and values around them, from pre-projected
    q, k, v [B,H,W,C], with the output projection. bias [heads, window^2,
    (window + overlap)^2]. Returns [B,H,W,C]."""
    _build.require_no_grad("fused_overlap_attention", q, k, v, wproj, bproj, bias)
    if q.device.type == "cpu":
        return fused_overlap_attention_plain(q, k, v, wproj, bproj, bias, window, overlap,
                                             num_heads)
    b, h, w, c = q.shape
    ows = window + overlap
    nq, nk, hd = window * window, ows * ows, c // num_heads
    if h % window or w % window:
        raise ValueError(f"fused_overlap_attention: {h}x{w} is not a multiple of the "
                         f"{window}-px window")
    if overlap % 2 or nq % 4 or nk > MAX_OCA_KEYS or nk < 32:
        raise ValueError(f"fused_overlap_attention: window {window} with overlap {overlap}; "
                         f"the kernel takes an even overlap, window^2 a multiple of 4 and "
                         f"32 to {MAX_OCA_KEYS} keys")
    if hd * num_heads != c or hd > MAX_HEAD_DIM or c % 4:
        raise ValueError(f"fused_overlap_attention: C={c} over {num_heads} heads; the kernel "
                         f"takes whole heads up to {MAX_HEAD_DIM} wide and C a multiple of 4")
    _build.require(q, "q")
    _build.require(k, "k", q.shape)
    _build.require(v, "v", q.shape)
    _build.require(wproj, "wproj", (c, c))
    _build.require(bproj, "bproj", (c,))
    _build.require(bias, "bias", (num_heads, nq, nk))
    kp = _ceil8(c)
    wpp = _padded_proj(wproj, kp, kp)
    lib = _build.library()
    att = torch.empty_like(q)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = _build.stream_ptr(q.device)
        err = lib.oca_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                                att.data_ptr(), b, h, w, c, window, ows, num_heads, hd, stream)
        _build.check(err, "oca_attention")
        err = lib.rows_linear(att.data_ptr(), wpp.data_ptr(), bproj.data_ptr(), out.data_ptr(),
                              b * h * w, c, c, kp, kp, stream)
    _build.check(err, "rows_linear")
    launches["fused_overlap_attention"] += 1
    return out


def fused_residual_ln_mlp_plain(a, shortcut, ln_w, ln_b, w1, b1, w2, b2):
    return _mlp_plain(a + shortcut, ln_w, ln_b, w1, b1, w2, b2)


def fused_residual_ln_mlp(a, shortcut, ln_w, ln_b, w1, b1, w2, b2):
    """Kernel B10 on CUDA, its plain version on the CPU: y = a + shortcut;
    out = y + fc2(GELU(fc1(LN y))) on [..., C] rows (any leading shape)."""
    _build.require_no_grad("fused_residual_ln_mlp", a, shortcut, ln_w, ln_b, w1, b1, w2, b2)
    if a.device.type == "cpu":
        return fused_residual_ln_mlp_plain(a, shortcut, ln_w, ln_b, w1, b1, w2, b2)
    c, hid = a.shape[-1], w1.shape[1]
    if c % 4:
        raise ValueError(f"fused_residual_ln_mlp: C={c} is not a multiple of 4")
    _build.require(a, "a")
    _build.require(shortcut, "shortcut", a.shape)
    for name, t, shape in (("ln_w", ln_w, (c,)), ("ln_b", ln_b, (c,)), ("w1", w1, (c, hid)),
                           ("b1", b1, (hid,)), ("w2", w2, (hid, c)), ("b2", b2, (c,))):
        _build.require(t, name, shape)
    kp, npad, k2p, w1p, w2p = _mlp_padded_weights(c, w1, w2)
    lib = _build.library()
    out = torch.empty_like(a)
    hidden = torch.empty((a.numel() // c, k2p), device=a.device, dtype=torch.float32)
    with torch.cuda.device(a.device):
        err = lib.residual_ln_mlp(a.data_ptr(), shortcut.data_ptr(), ln_w.data_ptr(),
                                  ln_b.data_ptr(), w1p.data_ptr(), b1.data_ptr(),
                                  w2p.data_ptr(), b2.data_ptr(), hidden.data_ptr(),
                                  out.data_ptr(), a.numel() // c, c, hid, kp, npad, k2p,
                                  _build.stream_ptr(a.device))
    _build.check(err, "residual_ln_mlp")
    launches["fused_residual_ln_mlp"] += 1
    return out
