"""Window attention kernels and their plain versions: DAT's rectangular-window attention
with the qkv projection fused in (B4) and from pre-projected images (B13), and HAT's fused
HAB block (B8), overlapping cross-attention (B9), residual + LayerNorm + MLP tail (B10) and
standalone window attention with both projections (B14).

Twins of ``freqfusion_tpu/ops/pallas/wattn.py``'s ``fused_window_attention_xqkv``,
``fused_window_attention_qkv``, ``fused_hab_block``, ``fused_overlap_attention``,
``fused_residual_ln_mlp`` and ``fused_window_attention``. On a CUDA tensor a wrapper
launches its kernels (``csrc/wattn.cu``, ``csrc/hab_attention.cu``, ``csrc/oca.cu``,
``csrc/hat_rows.cu``) or raises; on a CPU tensor it runs the plain PyTorch version. There is
no fallback from one to the other. Every product runs f32-exact on the tensor cores
(3xTF32): B4's and B8's attention (one kernel, windows of 64 to 256 tokens with heads up to
32 wide: ``xqkv_takes``), B13's and B9's attention (one key-streaming loop,
``csrc/flash_f32x3.cuh``: any window, any number of keys, any head width) and every row
product (B8's tail, B9's projection, B10, B14's projections); the row products' weights are
zero-padded to multiples of 8, the MMA's k and n, and split into TF32 hi and lo parts on the
host once for each weight (``_mma.planes``), and the attention's per-head slabs are made
once too (``head_slabs``). Dense weights come as [in,out] matrices of x @ w, as in the JAX
package; every LayerNorm uses eps 1e-5.

B4's layouts (NHWC, f32): x [B,H,W,Cin]; wqkv [Cin, 3*co] and bqkv [3*co], one branch's
q, k, v columns (co = num_heads * head_dim), or the whole projection with the branch's
``cols``; bias [num_heads, N, N] with N = window tokens; mask None, the numpy shift mask
[nW, N, N] of ``ops.windows.shift_attn_mask`` or its 4 window types as a tensor [4, N, N]
(see ``mask_types``). The result is the co-wide attended image [B,H,W,co], before any
output projection. The caller rolls x
before and the result after a shifted block; nothing here shifts. B13 takes the same bias
and mask with q, k, v [B,H,W,C] projected (and zero-padded to whole windows) by the caller;
B14 takes x [B,H,W,C] with the whole [C,3C] projection and the [C,C] output projection.

Every tensor of a call is float32, or every one bfloat16. At bfloat16 the plain versions and
the kernels compute what the TPU kernels compute on bf16 refs: each matmul operand rounded
to bf16 (LN outputs, q rounded and scaled by the bf16 scale, k, v, the probabilities, the
attention output, the GELU output, the weights), f32 accumulation, softmax, LayerNorm
statistics and the residual stream y in f32, and outputs rounded to bf16 once. The kernels
keep y in an f32 scratch where the f32 path parks it in the output, and sum a product's K
pieces there above _mma.MAX_ROW_K channels. At float32 with bf16 operands (``mxu_dtype``, or
precision "default": ``_mma.operand_dtype``) the same operands are rounded and every tensor
stays f32, as the TPU kernels compute on f32 refs with a bf16 ``mxu_dtype``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..common import layernorm
from ..windows import extract_overlapping_windows, window_partition, window_reverse
from . import _build, _mma

#: Kernel launches since the last reset. Plain runs are not counted.
launches = {"fused_window_attention_xqkv": 0, "fused_hab_block": 0,
            "fused_overlap_attention": 0, "fused_residual_ln_mlp": 0,
            "fused_window_attention_qkv": 0, "fused_window_attention": 0}

#: What csrc/hab_attention.cu (B4, B8's attention) takes: windows of 64, 128, 192 or 256
#: tokens, heads up to 32 wide. B13, B14 and B9 (csrc/flash_f32x3.cuh) take any.
MAX_TOKENS = 256
MAX_HEAD_DIM = 32
_SLOT = 32               # columns of one head's q, k or v in the padded weight


def xqkv_takes(tokens: int, head_dim: int) -> bool:
    """Whether B4 and B8's attention kernel takes windows of `tokens` tokens with heads
    `head_dim` wide. A model sends what it refuses to B13 (DAT) or B14 (HAT)."""
    return tokens % 64 == 0 and 0 < tokens <= MAX_TOKENS and 0 < head_dim <= MAX_HEAD_DIM


def mask_types(mask, n_wr: int, n_wc: int, device) -> torch.Tensor:
    """The shift mask reduced to its 4 window types [4,N,N] on `device`: 0 interior,
    1 last column, 2 last row, 3 corner. `mask` is the numpy mask [nW,N,N] of the whole
    image, which is checked window by window to equal its type (the JAX package asserts
    the same, so nothing is lost), or the 4 types themselves as a tensor [4,N,N]
    (``ops.windows.shift_mask_types``), which a caller keeps to spare building and checking
    O(image) * N^2 floats on every call."""
    if isinstance(mask, torch.Tensor) and mask.dim() == 3 and mask.shape[0] == 4:
        if mask.device != torch.device(device) or not mask.is_floating_point():
            raise ValueError(f"mask: expected floating window types on {device}, got "
                             f"{mask.dtype} on {mask.device}")
        # a bf16 model's copy holds the same {0, -100} exactly
        return mask.float()
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


def _scale(hd: int, dt) -> float:
    """1/sqrt(hd), in the operand dtype as the TPU kernels hold it (``jnp.asarray(hd ** -0.5,
    dt)``): rounded to bf16 at bf16 operands."""
    return float(torch.tensor(hd ** -0.5).to(dt)) if dt == torch.bfloat16 else hd ** -0.5


def _probs(scores: torch.Tensor, mdt) -> torch.Tensor:
    """The softmax over the last axis, rounded to the operand dtype for the product with v
    (``jax.nn.softmax(a).astype(dt)`` in the TPU kernels)."""
    return _mma.rnd(torch.softmax(scores, dim=-1), mdt)


def fused_window_attention_qkv_plain(q, k, v, bias, mask, window, num_heads, mxu_dtype=None):
    """Multi-head attention inside (hs, ws) windows of pre-projected images [B,H,W,C]:
    softmax(q k^T / sqrt(head_dim) + bias (+ mask)) v. Returns [B,H,W,C]."""
    b, h, w, c = q.shape
    hs, ws = window
    n, hd = hs * ws, c // num_heads
    dt = q.dtype
    mdt = _mma.operand_dtype(dt, mxu_dtype)
    q, k, v = (_mma.rnd(t, mdt) for t in (q, k, v))
    bias = _mma.up(bias)

    def to_wins(t):  # [B*nW, heads, N, hd]
        return window_partition(t, hs, ws).reshape(-1, n, num_heads, hd).permute(0, 2, 1, 3)

    attn = (_mma.rnd(to_wins(q) * _scale(hd, mdt), mdt) @ to_wins(k).transpose(-1, -2)
            + bias[None])
    if mask is not None:
        n_wr, n_wc = h // hs, w // ws
        per_win = mask_types(mask, n_wr, n_wc, q.device)[_type_index(n_wr, n_wc, q.device)]
        attn = (attn.reshape(b, n_wr * n_wc, num_heads, n, n)
                + per_win[None, :, None]).reshape(-1, num_heads, n, n)
    out = _mma.rnd(_probs(attn, mdt) @ to_wins(v), mdt)   # each head's output, as an operand
    return window_reverse(out.permute(0, 2, 1, 3).reshape(-1, n, c), hs, ws, h, w).to(dt)


def _launch_qkv(lib, q_ptr, k_ptr, v_ptr, ld, bias, types, out, window, num_heads, name, io):
    """csrc/wattn.cu's pre-projected attention into `out` [B,H,W,C]; q, k, v are device
    addresses of images of out's dtype with `ld` elements a pixel; `io` the instantiation
    (``_build.io_code``)."""
    b, h, w, c = out.shape
    bias = _mma.up(bias).contiguous()
    with torch.cuda.device(out.device):
        err = lib.wattn_qkv(q_ptr, k_ptr, v_ptr, bias.data_ptr(),
                            0 if types is None else types.data_ptr(), out.data_ptr(), b, h, w,
                            ld, window[0], window[1], num_heads, c // num_heads, io,
                            _build.stream_ptr(out.device))
    _build.check(err, name)


def _check_qkv_shape(name, h, w, c, window, num_heads):
    hs, ws = window
    if h % hs or w % ws:
        raise ValueError(f"{name}: {h}x{w} is not a multiple of the {hs}x{ws} window")
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"{name}: C={c} does not split into {num_heads} whole heads")


def fused_window_attention_qkv(q, k, v, bias, mask, window, num_heads, mxu_dtype=None):
    """Kernel B13 on CUDA, its plain version on the CPU: multi-head attention inside
    (hs, ws) windows of pre-projected q, k, v [B,H,W,C], already zero-padded to whole
    windows and already rolled in a shifted block; any window and head width. A zero-padded
    key is not masked: it scores its bias and takes part in the softmax. Returns [B,H,W,C].
    `mxu_dtype`: the matmul operand dtype (``_mma.operand_dtype``; None: the process-wide
    one), as for every wrapper here."""
    name = "fused_window_attention_qkv"
    _build.require_no_grad(name, q, k, v, bias)
    _build.require_dtypes(name, q, k, v, bias)
    if q.device.type == "cpu":
        return fused_window_attention_qkv_plain(q, k, v, bias, mask, window, num_heads,
                                                mxu_dtype)
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
                out, window, num_heads, "wattn_qkv", _build.io_code(q, "q", mxu_dtype))
    _build.count(launches, name)
    return out


def fused_window_attention_plain(x, wqkv, bqkv, wproj, bproj, bias, mask, window, num_heads,
                                 mxu_dtype=None):
    dt = x.dtype
    mdt = _mma.operand_dtype(dt, mxu_dtype)
    x, wqkv, bqkv, wproj, bproj = map(_mma.up, (x, wqkv, bqkv, wproj, bproj))
    q, k, v = (_mma.rnd(x, mdt) @ _mma.rnd(wqkv, mdt) + bqkv).to(dt).chunk(3, dim=-1)
    att = fused_window_attention_qkv_plain(q, k, v, bias, mask, window, num_heads, mxu_dtype)
    return (_mma.rnd(att, mdt) @ _mma.rnd(wproj, mdt) + bproj).to(dt)


def _rows_linear(lib, a, wp, bp, out, kp, np_, io, name="rows_linear"):
    """csrc/hat_rows.cu's row product out [..., Cout] = a [..., C] @ w + b on the current
    stream (wp the planes of w [kp, np_], bp f32; `io` the instantiation, ``_build.io_code``);
    at bf16 with K in pieces its sums go through an f32 scratch."""
    c, cout = a.shape[-1], out.shape[-1]
    y = (torch.empty(out.shape, device=a.device, dtype=torch.float32)
         if io == 1 and kp > _mma.MAX_ROW_K else None)
    with torch.cuda.device(a.device):
        err = lib.rows_linear(a.data_ptr(), wp.data_ptr(), bp.data_ptr(), out.data_ptr(),
                              None if y is None else y.data_ptr(), a.numel() // c, c, cout, kp,
                              np_, io, _build.stream_ptr(a.device))
    _build.check(err, name)


def fused_window_attention(x, wqkv, bqkv, wproj, bproj, bias, mask, window, num_heads,
                           mxu_dtype=None):
    """Kernel B14 on CUDA, its plain version on the CPU: one (S)W-MSA pass over an already
    rolled image x [B,H,W,C] of any parity, qkv projection [C,3C] -> attention in
    (hs, ws) windows with bias [heads,N,N] (+ the shift mask) -> output projection [C,C].
    Returns [B,H,W,C]. Three launches: the row product of csrc/hat_rows.cu on either side
    of csrc/wattn.cu's pre-projected attention; q, k, v pass through device memory once."""
    name = "fused_window_attention"
    _build.require_no_grad(name, x, wqkv, bqkv, wproj, bproj, bias)
    _build.require_dtypes(name, x, wqkv, bqkv, wproj, bproj, bias)
    if x.device.type == "cpu":
        return fused_window_attention_plain(x, wqkv, bqkv, wproj, bproj, bias, mask, window,
                                            num_heads, mxu_dtype)
    b, h, w, c = x.shape
    hs, ws = window
    n = hs * ws
    _check_qkv_shape(name, h, w, c, window, num_heads)
    if c % 4:
        raise ValueError(f"{name}: C={c} is not a multiple of 4")
    dt = x.dtype
    _build.require(x, "x")
    for nm, t, shape in (("bqkv", bqkv, (3 * c,)), ("bproj", bproj, (c,)),
                         ("bias", bias, (num_heads, n, n))):
        _build.require(t, nm, shape)
    # the weights are laid out anew (_mma.planes): a view will do
    _build.require(wqkv, "wqkv", (c, 3 * c), contiguous=False)
    _build.require(wproj, "wproj", (c, c), contiguous=False)
    types = None if mask is None else mask_types(mask, h // hs, w // ws, x.device)
    io = _build.io_code(x, mxu_dtype=mxu_dtype)
    kp, np3 = _ceil8(c), _ceil8(3 * c)
    wq, wpp = _mma.planes(wqkv, kp, np3, io == 2), _mma.planes(wproj, kp, kp, io == 2)
    lib = _build.library()
    # q | k | v in x's dtype: the attention rounds them to its operand dtype
    qkv = torch.empty((b, h, w, 3 * c), device=x.device, dtype=dt)
    att = torch.empty_like(x)
    out = torch.empty_like(x)
    _rows_linear(lib, x, wq, _mma.f32(bqkv), qkv, kp, np3, io)
    p, e = qkv.data_ptr(), qkv.element_size()
    _launch_qkv(lib, p, p + e * c, p + 2 * e * c, 3 * c, bias, types, att, window, num_heads,
                "wattn_qkv", io)
    _rows_linear(lib, att, wpp, _mma.f32(bproj), out, kp, kp, io)
    _build.count(launches, name)
    return out


def fused_window_attention_xqkv_plain(x, wqkv, bqkv, bias, mask, window, num_heads,
                                      mxu_dtype=None):
    """Project this branch's q, k, v from x, then fused_window_attention_qkv_plain."""
    dt = x.dtype
    mdt = _mma.operand_dtype(dt, mxu_dtype)
    q, k, v = (_mma.rnd(x, mdt) @ _mma.rnd(wqkv, mdt) + _mma.up(bqkv)).to(dt).chunk(3, dim=-1)
    return fused_window_attention_qkv_plain(q, k, v, bias, mask, window, num_heads, mxu_dtype)


def branch_qkv(wqkv, bqkv, off: int, width: int):
    """One branch's [Cin,3*width] projection and its bias: columns off .. off+width of each
    of the q, k and v thirds of a whole [Cin,3C] projection (DAT's two branches)."""
    c = wqkv.shape[1] // 3
    cols = [slice(s * c + off, s * c + off + width) for s in range(3)]
    return (torch.cat([wqkv[:, sl] for sl in cols], dim=1).contiguous(),
            torch.cat([bqkv[sl] for sl in cols]))


def _padded_head_weights(wqkv, bqkv, num_heads: int, hd: int, kp: int):
    """wqkv [Cin,3*co] -> [heads, kp, 96] with head h's q, k, v in columns 0.., 32.., 64..
    (zeros elsewhere, rows Cin..kp zero too), and bqkv -> [heads, 96] likewise: the slabs of
    csrc/hab_attention.cu, kp a multiple of 8; padded zeros change nothing."""
    cin = wqkv.shape[0]
    wh = wqkv.new_zeros(num_heads, kp, 3, _SLOT)
    wh[:, :cin, :, :hd] = wqkv.reshape(cin, 3, num_heads, hd).permute(2, 0, 1, 3)
    bh = bqkv.new_zeros(num_heads, 3, _SLOT)
    bh[:, :, :hd] = bqkv.reshape(3, num_heads, hd).permute(1, 0, 2)
    return wh.reshape(num_heads, kp, 3 * _SLOT), bh.reshape(num_heads, 3 * _SLOT)


def head_slabs(wqkv, bqkv, num_heads: int, hd: int, kp: int, cols=None):
    """``_padded_head_weights`` of wqkv and bqkv, or with ``cols = (off, width)`` of the
    branch ``branch_qkv(wqkv, bqkv, off, width)``, made once for each weight and kept beside
    it (``_mma.kept``): a model passes its own parameter (a view such as
    ``qkv.weight.t()``), and the slabs follow it when it changes in place or moves."""
    def make():
        w, b = (wqkv, bqkv) if cols is None else branch_qkv(wqkv, bqkv, *cols)
        return _padded_head_weights(_mma.up(w), _mma.up(b), num_heads, hd, kp)

    return _mma.kept(("head_slabs", num_heads, hd, kp, cols), make, wqkv, bqkv)


def fused_window_attention_xqkv(x, wqkv, bqkv, bias, mask, window, num_heads, cols=None,
                                mxu_dtype=None):
    """Kernel B4 on CUDA, its plain version on the CPU. Returns [B,H,W,co].

    With ``cols = (off, width)`` wqkv [Cin,3C] and bqkv [3C] are a whole projection and the
    attention takes the branch ``branch_qkv(wqkv, bqkv, off, width)``: DAT passes its own
    qkv parameter so that the kernel's head slabs are made once for each weight and branch
    (``head_slabs``), where the branch's columns, cut on every call, would be new tensors."""
    name = "fused_window_attention_xqkv"
    _build.require_no_grad(name, x, wqkv, bqkv, bias)
    _build.require_dtypes(name, x, wqkv, bqkv, bias)
    if x.device.type == "cpu":
        if cols is not None:
            wqkv, bqkv = branch_qkv(wqkv, bqkv, *cols)
        return fused_window_attention_xqkv_plain(x, wqkv, bqkv, bias, mask, window,
                                                 num_heads, mxu_dtype)
    b, h, w, cin = x.shape
    hs, ws = window
    n = hs * ws
    co = wqkv.shape[1] // 3 if cols is None else cols[1]
    hd = co // num_heads
    if h % hs or w % ws:
        raise ValueError(f"{name}: {h}x{w} is not a multiple of the {hs}x{ws} window")
    if hd * num_heads != co or not xqkv_takes(n, hd):
        raise ValueError(f"{name}: {n} tokens per window, {co} columns over {num_heads} heads; "
                         f"the kernel takes multiples of 64 tokens up to {MAX_TOKENS} and "
                         f"whole heads up to {MAX_HEAD_DIM} wide (B13 takes the rest)")
    if cin % 4:
        raise ValueError(f"{name}: Cin={cin} is not a multiple of 4")
    dt = x.dtype
    _build.require(x, "x")
    # the weights are laid out anew (head_slabs): a view will do
    _build.require(wqkv, "wqkv", (cin, wqkv.shape[1] if cols else 3 * co), contiguous=False)
    _build.require(bqkv, "bqkv", (wqkv.shape[1],))
    if cols is not None and (wqkv.shape[1] % 3 or cols[0] < 0 or
                             cols[0] + cols[1] > wqkv.shape[1] // 3):
        raise ValueError(f"{name}: columns {cols} are not inside each third of a "
                         f"[{cin},{wqkv.shape[1]}] projection")
    _build.require(bias, "bias", (num_heads, n, n))
    types = None if mask is None else mask_types(mask, h // hs, w // ws, x.device)
    wh, bh = head_slabs(wqkv, bqkv, num_heads, hd, _ceil8(cin), cols)
    out = torch.empty((b, h, w, co), device=x.device, dtype=dt)
    _launch_xqkv(_build.library(), x, None, None, wh, bh, bias, types, out, window, num_heads,
                 hd, 0, _build.io_code(x, mxu_dtype=mxu_dtype))
    _build.count(launches, name)
    return out


def _launch_xqkv(lib, x, ln_w, ln_b, wh, bh, bias, types, out, window, num_heads, hd, shift,
                 io):
    """csrc/hab_attention.cu's attention of x's windows into `out` [B,H,W,heads*hd], with
    the LayerNorm (ln_w, ln_b) on load where they are given; `io` the instantiation
    (``_build.io_code``). The head slabs go as they are: the kernel rounds them at bf16
    operands where their fragments are set."""
    b, h, w, cin = x.shape
    ln_w, ln_b = (None if t is None else _mma.f32(t) for t in (ln_w, ln_b))
    bias = _mma.up(bias).contiguous()
    with torch.cuda.device(x.device):
        err = lib.xqkv_attention(x.data_ptr(), 0 if ln_w is None else ln_w.data_ptr(),
                                 0 if ln_b is None else ln_b.data_ptr(), wh.data_ptr(),
                                 bh.data_ptr(), bias.data_ptr(),
                                 0 if types is None else types.data_ptr(), out.data_ptr(),
                                 b, h, w, cin, wh.shape[1], window[0], window[1], num_heads,
                                 hd, shift, io, _build.stream_ptr(x.device))
    _build.check(err, "xqkv_attention")


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def _mlp_planes(c: int, w1, w2, bf16: bool = False):
    """(kp, k2p, w1p, w2p) for an MLP on C-wide rows: fc1's weights [kp,k2p] and fc2's
    [k2p,kp] as tile_mma's planes (_mma.planes, made once a weight; of their bf16 roundings
    with `bf16`). The row products take K and N in multiples of 8, and the hidden, fc1's N
    and fc2's K, passes through a buffer k2p wide; padded zeros change nothing."""
    kp, k2p = _ceil8(c), _ceil8(w1.shape[1])
    return kp, k2p, _mma.planes(w1, kp, k2p, bf16), _mma.planes(w2, k2p, kp, bf16)


def _mlp_plain(y, ln_w, ln_b, w1, b1, w2, b2, mdt=torch.float32):
    """y + fc2(GELU(fc1(LN y))) on f32 (or f64) y, the products' operands (the weights too)
    rounded to the operand dtype `mdt`."""
    ln_w, ln_b, w1, b1, w2, b2 = map(_mma.up, (ln_w, ln_b, w1, b1, w2, b2))
    w1, w2 = _mma.rnd(w1, mdt), _mma.rnd(w2, mdt)
    h = _mma.rnd(F.gelu(_mma.rnd(layernorm(y, ln_w, ln_b), mdt) @ w1 + b1), mdt)
    return y + h @ w2 + b2


def _hab_attention_plain(x, ln1_w, ln1_b, wqkv, bqkv, bias, mask, window, num_heads,
                         in_shift: int = 0, mxu_dtype=None):
    """B8's first launch: the window attention of LN1 x, x read at (+s, +s) with wrap-around
    for in_shift = s. Returns the heads' output [B,H,W,C] in x's dtype."""
    dt = x.dtype
    mdt = _mma.operand_dtype(dt, mxu_dtype)
    x, ln1_w, ln1_b, wqkv, bqkv = map(_mma.up, (x, ln1_w, ln1_b, wqkv, bqkv))
    xs = torch.roll(x, (-in_shift, -in_shift), dims=(1, 2)) if in_shift else x
    q, k, v = (_mma.rnd(layernorm(xs, ln1_w, ln1_b), mdt) @ _mma.rnd(wqkv, mdt)
               + bqkv).to(dt).chunk(3, dim=-1)
    return fused_window_attention_qkv_plain(q, k, v, bias, mask, window, num_heads, mxu_dtype)


def _hab_tail_plain(att, x, conv_x, ln2_w, ln2_b, wproj, bproj, w1, b1, w2, b2, conv_scale,
                    cab_scale=None, in_shift: int = 0, mxu_dtype=None):
    """B8's second launch on the heads' output att: y = x + proj(att) + conv_scale *
    cab_scale * conv_x (x read as the first launch reads it), then y + fc2(GELU(fc1(LN2 y)))."""
    dt = x.dtype
    mdt = _mma.operand_dtype(dt, mxu_dtype)
    x, conv_x, wproj, bproj = map(_mma.up, (x, conv_x, wproj, bproj))
    xs = torch.roll(x, (-in_shift, -in_shift), dims=(1, 2)) if in_shift else x
    cx = conv_x if cab_scale is None else conv_x * _mma.up(cab_scale)
    y = xs + _mma.rnd(att, mdt) @ _mma.rnd(wproj, mdt) + bproj + conv_scale * cx
    return _mlp_plain(y, ln2_w, ln2_b, w1, b1, w2, b2, mdt).to(dt)


def fused_hab_block_plain(x, conv_x, ln1_w, ln1_b, ln2_w, ln2_b, wqkv, bqkv, wproj, bproj,
                          w1, b1, w2, b2, bias, mask, window, num_heads, conv_scale,
                          cab_scale=None, in_shift: int = 0, mxu_dtype=None):
    att = _hab_attention_plain(x, ln1_w, ln1_b, wqkv, bqkv, bias, mask, window, num_heads,
                               in_shift, mxu_dtype)
    return _hab_tail_plain(att, x, conv_x, ln2_w, ln2_b, wproj, bproj, w1, b1, w2, b2,
                           conv_scale, cab_scale, in_shift, mxu_dtype)


def fused_hab_block(x, conv_x, ln1_w, ln1_b, ln2_w, ln2_b, wqkv, bqkv, wproj, bproj, w1, b1,
                    w2, b2, bias, mask, window, num_heads, conv_scale, cab_scale=None,
                    in_shift: int = 0, mxu_dtype=None):
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
    _build.require_dtypes("fused_hab_block", x, conv_x, ln1_w, ln1_b, ln2_w, ln2_b, wqkv, bqkv,
                          wproj, bproj, w1, b1, w2, b2, bias)
    wsh, wsw = window
    if in_shift and (mask is None or 2 * in_shift != wsh or 2 * in_shift != wsw):
        raise ValueError(f"fused_hab_block: in_shift={in_shift} needs a shift mask and a "
                         f"window of twice the shift, got {wsh}x{wsw}")
    if x.device.type == "cpu":
        return fused_hab_block_plain(x, conv_x, ln1_w, ln1_b, ln2_w, ln2_b, wqkv, bqkv, wproj,
                                     bproj, w1, b1, w2, b2, bias, mask, window, num_heads,
                                     conv_scale, cab_scale, in_shift, mxu_dtype)
    attention, tail, _, out = _hab_block_launchers(
        x, conv_x, ln1_w, ln1_b, ln2_w, ln2_b, wqkv, bqkv, wproj, bproj, w1, b1, w2, b2, bias,
        mask, window, num_heads, conv_scale, cab_scale, in_shift, mxu_dtype)
    attention()
    tail()
    _build.count(launches, "fused_hab_block")
    return out


def _hab_block_launchers(x, conv_x, ln1_w, ln1_b, ln2_w, ln2_b, wqkv, bqkv, wproj, bproj, w1,
                         b1, w2, b2, bias, mask, window, num_heads, conv_scale, cab_scale,
                         in_shift, mxu_dtype=None):
    """Checks B8's CUDA arguments and lays out its weights; returns (attention, tail, att,
    out): two functions that each launch one half of the block on the current stream, the
    heads' output that the attention writes and the tail reads, and the output they fill.
    ``fused_hab_block`` calls both; a caller may time or check them apart."""
    wsh, wsw = window
    b, h, w, c = x.shape
    n, hd, hid = wsh * wsw, c // num_heads, w1.shape[1]
    if wsh != wsw or h % wsh or w % wsw:
        raise ValueError(f"fused_hab_block: {h}x{w} is not a multiple of a square window, "
                         f"got {wsh}x{wsw}")
    if hd * num_heads != c or not xqkv_takes(n, hd) or c % 4:
        raise ValueError(f"fused_hab_block: {n} tokens per window, C={c} over {num_heads} "
                         f"heads; the kernel takes multiples of 64 tokens up to {MAX_TOKENS}, "
                         f"whole heads up to {MAX_HEAD_DIM} wide and C a multiple of 4 (B14 "
                         "takes the rest)")
    io = _build.io_code(x, mxu_dtype=mxu_dtype)
    _build.require(x, "x")
    _build.require(conv_x, "conv_x", x.shape)
    for name, t, shape in (("ln1_w", ln1_w, (c,)), ("ln1_b", ln1_b, (c,)),
                           ("ln2_w", ln2_w, (c,)), ("ln2_b", ln2_b, (c,)),
                           ("bqkv", bqkv, (3 * c,)), ("bproj", bproj, (c,)), ("b1", b1, (hid,)),
                           ("b2", b2, (c,)), ("bias", bias, (num_heads, n, n))):
        _build.require(t, name, shape)
    # the weights are laid out anew (_mma.planes, head_slabs): a view will do
    for name, t, shape in (("wqkv", wqkv, (c, 3 * c)), ("wproj", wproj, (c, c)),
                           ("w1", w1, (c, hid)), ("w2", w2, (hid, c))):
        _build.require(t, name, shape, contiguous=False)
    if cab_scale is not None:   # may be f32 (from B7's f32 sums) where x is bf16
        _build.require(cab_scale, "cab_scale", (b, 1, 1, c))
        cab_scale = _mma.up(cab_scale).contiguous()
    types = None if mask is None else mask_types(mask, h // wsh, w // wsw, x.device)
    kp, k2p, w1p, w2p = _mlp_planes(c, w1, w2, io == 2)
    wh, bh = head_slabs(wqkv, bqkv, num_heads, hd, kp)
    wpp = _mma.planes(wproj, kp, kp, io == 2)
    bproj, ln2_w, ln2_b, b1, b2 = map(_mma.f32, (bproj, ln2_w, ln2_b, b1, b2))
    lib = _build.library()
    att = torch.empty_like(x)
    out = torch.empty_like(x)
    hidden = torch.empty((b, h, w, k2p), device=x.device, dtype=torch.float32)
    # y between the products: f32 scratch at bf16 (out holds it at f32 storage)
    y = torch.empty(x.shape, device=x.device, dtype=torch.float32) if io == 1 else None

    def attention():
        _launch_xqkv(lib, x, ln1_w, ln1_b, wh, bh, bias, types, att, window, num_heads, hd,
                     in_shift, io)

    def tail():
        with torch.cuda.device(x.device):
            err = lib.hab_tail(att.data_ptr(), x.data_ptr(), conv_x.data_ptr(),
                               0 if cab_scale is None else cab_scale.data_ptr(),
                               wpp.data_ptr(), bproj.data_ptr(), ln2_w.data_ptr(),
                               ln2_b.data_ptr(), w1p.data_ptr(), b1.data_ptr(), w2p.data_ptr(),
                               b2.data_ptr(), hidden.data_ptr(), out.data_ptr(),
                               None if y is None else y.data_ptr(), b, h, w, c, hid, kp, kp,
                               k2p, in_shift, float(conv_scale), io,
                               _build.stream_ptr(x.device))
        _build.check(err, "hab_tail")

    return attention, tail, att, out


def fused_overlap_attention_plain(q, k, v, wproj, bproj, bias, window: int, overlap: int,
                                  num_heads: int, mxu_dtype=None):
    b, h, w, c = q.shape
    hd = c // num_heads
    dt = q.dtype
    mdt = _mma.operand_dtype(dt, mxu_dtype)
    q, k, v, wproj = (_mma.rnd(t, mdt) for t in (q, k, v, wproj))
    bproj, bias = _mma.up(bproj), _mma.up(bias)

    def heads(t):  # [B*nW, n, C] -> [B*nW, heads, n, hd]
        return t.reshape(t.shape[0], t.shape[1], num_heads, hd).permute(0, 2, 1, 3)

    # k and v are zero-padded after their projection: a padded key scores its bias alone
    kw = heads(extract_overlapping_windows(k, window, overlap))
    vw = heads(extract_overlapping_windows(v, window, overlap))
    qs = _mma.rnd(heads(window_partition(q, window, window)) * _scale(hd, mdt), mdt)
    attn = qs @ kw.transpose(-1, -2)
    out = _probs(attn + bias[None], mdt) @ vw
    out = _mma.rnd(out.permute(0, 2, 1, 3).reshape(-1, window * window, c), mdt) @ wproj + bproj
    return window_reverse(out, window, window, h, w).to(dt)


def fused_overlap_attention(q, k, v, wproj, bproj, bias, window: int, overlap: int,
                            num_heads: int, mxu_dtype=None):
    """Kernel B9 on CUDA, its plain version on the CPU: OCAB's attention of window x window
    queries over the (window + overlap)^2 keys and values around them, from pre-projected
    q, k, v [B,H,W,C], with the output projection. bias [heads, window^2,
    (window + overlap)^2]. Returns [B,H,W,C]."""
    _build.require_no_grad("fused_overlap_attention", q, k, v, wproj, bproj, bias)
    _build.require_dtypes("fused_overlap_attention", q, k, v, wproj, bproj, bias)
    if q.device.type == "cpu":
        return fused_overlap_attention_plain(q, k, v, wproj, bproj, bias, window, overlap,
                                             num_heads, mxu_dtype)
    attention, proj, out = _overlap_launchers(q, k, v, wproj, bproj, bias, window, overlap,
                                              num_heads, mxu_dtype)
    attention()
    proj()
    _build.count(launches, "fused_overlap_attention")
    return out


def _overlap_launchers(q, k, v, wproj, bproj, bias, window, overlap, num_heads,
                       mxu_dtype=None):
    """Checks B9's CUDA arguments and lays out its projection; returns (attention, proj,
    out): two functions that each launch one half on the current stream (the projection
    reads what the attention wrote) and the output they fill. ``fused_overlap_attention``
    calls both; a caller may time them apart."""
    b, h, w, c = q.shape
    ows = window + overlap
    nq, nk, hd = window * window, ows * ows, c // num_heads
    if h % window or w % window:
        raise ValueError(f"fused_overlap_attention: {h}x{w} is not a multiple of the "
                         f"{window}-px window")
    if overlap % 2 or overlap < 0:
        raise ValueError(f"fused_overlap_attention: window {window} with overlap {overlap}; "
                         f"the kernel takes an even overlap")
    if hd * num_heads != c or c % 4:
        raise ValueError(f"fused_overlap_attention: C={c} over {num_heads} heads; the kernel "
                         f"takes whole heads and C a multiple of 4")
    io = _build.io_code(q, "q", mxu_dtype)
    _build.require(q, "q")
    _build.require(k, "k", q.shape)
    _build.require(v, "v", q.shape)
    # laid out anew: a view will do
    _build.require(wproj, "wproj", (c, c), contiguous=False)
    _build.require(bproj, "bproj", (c,))
    _build.require(bias, "bias", (num_heads, nq, nk))
    kp = _ceil8(c)
    wpp = _mma.planes(wproj, kp, kp, io == 2)
    bproj, bias = _mma.f32(bproj), _mma.up(bias).contiguous()
    lib = _build.library()
    att = torch.empty_like(q)
    out = torch.empty_like(q)

    def attention():
        with torch.cuda.device(q.device):
            err = lib.oca_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                                    att.data_ptr(), b, h, w, c, window, ows, num_heads, hd, io,
                                    _build.stream_ptr(q.device))
        _build.check(err, "oca_attention")

    def proj():
        _rows_linear(lib, att, wpp, bproj, out, kp, kp, io)

    return attention, proj, out


def fused_residual_ln_mlp_plain(a, shortcut, ln_w, ln_b, w1, b1, w2, b2, mxu_dtype=None):
    return _mlp_plain(_mma.up(a) + _mma.up(shortcut), ln_w, ln_b, w1, b1, w2, b2,
                      _mma.operand_dtype(a.dtype, mxu_dtype)).to(a.dtype)


def fused_residual_ln_mlp(a, shortcut, ln_w, ln_b, w1, b1, w2, b2, mxu_dtype=None):
    """Kernel B10 on CUDA, its plain version on the CPU: y = a + shortcut;
    out = y + fc2(GELU(fc1(LN y))) on [..., C] rows (any leading shape)."""
    _build.require_no_grad("fused_residual_ln_mlp", a, shortcut, ln_w, ln_b, w1, b1, w2, b2)
    _build.require_dtypes("fused_residual_ln_mlp", a, shortcut, ln_w, ln_b, w1, b1, w2, b2)
    if a.device.type == "cpu":
        return fused_residual_ln_mlp_plain(a, shortcut, ln_w, ln_b, w1, b1, w2, b2, mxu_dtype)
    c, hid = a.shape[-1], w1.shape[1]
    if c % 4:
        raise ValueError(f"fused_residual_ln_mlp: C={c}; the kernel takes C a multiple of 4")
    io = _build.io_code(a, "a", mxu_dtype)
    _build.require(a, "a")
    _build.require(shortcut, "shortcut", a.shape)
    for name, t, shape in (("ln_w", ln_w, (c,)), ("ln_b", ln_b, (c,)), ("b1", b1, (hid,)),
                           ("b2", b2, (c,))):
        _build.require(t, name, shape)
    # w1 and w2 are laid out anew (_mma.planes): a view will do
    _build.require(w1, "w1", (c, hid), contiguous=False)
    _build.require(w2, "w2", (hid, c), contiguous=False)
    kp, k2p, w1p, w2p = _mlp_planes(c, w1, w2, io == 2)
    ln_w, ln_b, b1, b2 = map(_mma.f32, (ln_w, ln_b, b1, b2))
    lib = _build.library()
    out = torch.empty_like(a)
    f32 = dict(device=a.device, dtype=torch.float32)
    hidden = torch.empty((a.numel() // c, k2p), **f32)
    # y between the products: f32 scratch at bf16 (out holds it at f32 storage)
    y = torch.empty(a.shape, **f32) if io == 1 else None
    with torch.cuda.device(a.device):
        err = lib.residual_ln_mlp(a.data_ptr(), shortcut.data_ptr(), ln_w.data_ptr(),
                                  ln_b.data_ptr(), w1p.data_ptr(), b1.data_ptr(),
                                  w2p.data_ptr(), b2.data_ptr(), hidden.data_ptr(),
                                  out.data_ptr(), None if y is None else y.data_ptr(),
                                  a.numel() // c, c, hid, kp, kp, k2p, io,
                                  _build.stream_ptr(a.device))
    _build.check(err, "residual_ln_mlp")
    _build.count(launches, "fused_residual_ln_mlp")
    return out
