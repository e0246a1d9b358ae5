"""DAT's rectangular-window attention with the qkv projection fused in: kernel B4 and its
plain version.

Twin of ``freqfusion_tpu/ops/pallas/wattn.py:fused_window_attention_xqkv``. On a CUDA
tensor the wrapper launches the kernel from ``csrc/wattn.cu`` or raises; on a CPU tensor it
runs the plain PyTorch version. There is no fallback from one to the other.

Layouts (NHWC, f32): x [B,H,W,Cin]; wqkv [Cin, 3*co] and bqkv [3*co], one branch's q, k, v
columns (co = num_heads * head_dim); bias [num_heads, N, N] with N = window tokens; mask
None, the numpy shift mask [nW, N, N] of ``ops.windows.shift_attn_mask`` or its 4 window
types as a tensor [4, N, N] (see ``mask_types``). The result is
the co-wide attended image [B,H,W,co], before any output projection. The caller rolls x
before and the result after a shifted block; nothing here shifts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..windows import window_partition, window_reverse
from . import _build

#: Kernel launches since the last reset. Plain runs are not counted.
launches = {"fused_window_attention_xqkv": 0}

#: What csrc/wattn.cu takes: windows of 64, 128, 192 or 256 tokens, heads up to 32 wide.
MAX_TOKENS = 256
MAX_HEAD_DIM = 32
_SLOT = 32               # columns of one head's q, k or v in the padded weight
_WCOLS = 4 * _SLOT       # q | k | v | zeros: a multiple of the 64-column weight pass


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


def window_attention_plain(q, k, v, bias, mask, window, num_heads):
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


def fused_window_attention_xqkv_plain(x, wqkv, bqkv, bias, mask, window, num_heads):
    """Project this branch's q, k, v from x, then window_attention_plain."""
    q, k, v = (x @ wqkv + bqkv).chunk(3, dim=-1)
    return window_attention_plain(q, k, v, bias, mask, window, num_heads)


def _padded_head_weights(wqkv, bqkv, num_heads: int, hd: int, kp: int):
    """wqkv [Cin,3*co] -> [heads, kp, 128] with head h's q, k, v in columns 0.., 32..,
    64.. (zeros elsewhere, rows Cin..kp zero too), and bqkv -> [heads, 128] likewise: the
    kernel's streamed product takes K in steps of 16 and N in steps of 64, and padded
    zeros change nothing."""
    cin = wqkv.shape[0]
    wh = wqkv.new_zeros(num_heads, kp, 4, _SLOT)
    wh[:, :cin, :3, :hd] = wqkv.reshape(cin, 3, num_heads, hd).permute(2, 0, 1, 3)
    bh = bqkv.new_zeros(num_heads, 4, _SLOT)
    bh[:, :3, :hd] = bqkv.reshape(3, num_heads, hd).permute(1, 0, 2)
    return wh.reshape(num_heads, kp, _WCOLS), bh.reshape(num_heads, _WCOLS)


def fused_window_attention_xqkv(x, wqkv, bqkv, bias, mask, window, num_heads):
    """Kernel B4 on CUDA, its plain version on the CPU. Returns [B,H,W,co]."""
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
