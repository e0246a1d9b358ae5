"""Weights for the f32-exact tensor-core row product (``csrc/mma_f32x3.cuh``: ``tile_mma``),
split and laid out once on the host.

``tile_mma`` multiplies in 3xTF32: each f32 operand x is taken as hi + lo, hi its TF32
rounding (to nearest, ties away from zero) and lo the remainder, and three TF32 products
(lo*hi, hi*lo, hi*hi) are added. The activations are split in the kernel; the weights come
split from here, so that the kernel loads their two parts and splits nothing:

* ``split_tf32(w)`` gives ``(w_hi, w_lo)`` with ``w_hi + w_lo == w`` bit for bit, by integer
  ops on the f32 bits as the kernel's ``split_tf32`` does: ``(bits + 0x1000) & 0xffffe000``;
* ``mma_planes(wp)`` takes the weight matrix [kp,npad], already zero-padded to multiples of
  8 (the MMA's k and n), and lays both parts out in the order of ``mma.sync.m16n8k8``'s B
  fragments: [kp/8 k-steps][npad/8 n-tiles][32 lanes][4], lane 4g + t holding
  (hi[t][g], hi[t+4][g], lo[t][g], lo[t+4][g]) of its 8x8 tile, so that a lane reads its
  whole fragment as one 16-byte load. lo is stored with half a TF32 ulp added to its bits,
  as the kernel's split stores it: the MMA reads an operand's top 19 bits, so it then takes
  lo rounded to nearest;
* ``planes(w, kp, npad)`` is what the wrappers call: ``mma_planes`` of w [K,N] zero-padded
  to [kp,npad] (``padded``), made once for each weight and kept beside it (``kept``, which
  the attention's head slabs and B1's planes use too), so that a forward does not split
  and re-lay its constant weights on every call;
* ``fragments(w)`` is the same B-fragment order without the split, [K/8][N/8][32][2], made
  once for each weight: for a kernel that keeps a weight resident in shared memory, where
  the planes would take twice the room, and splits each fragment as it loads it (B11).

bf16 weights (FREQFUSION_DTYPE=bfloat16): a bf16 value is exact in TF32, so its hi plane is
the value itself and its lo plane is zero; the bf16 kernels run one TF32 pass (the exact
bf16-operand product) and never read lo. The planes and fragments hold f32 in both cases, and
``kept`` keys them by dtype, so that an f32 and a bf16 copy of one weight never share planes.

Precision "default" (f32 storage, bf16 operands: the JAX package's shipped serving numerics,
``wattn._mxu_dtype``): the kernels' one-pass instantiation on f32 tensors. The operand dtype of
a call is ``operand_dtype``: the wrapper's ``mxu_dtype`` where the caller gives one, else the
process-wide one that ``operands`` sets (``infer.io.pinned_precision`` at "default"), else the
storage dtype. At bf16 operands an f32 weight's planes are those of its bf16 rounding (``bf16``
planes: hi the rounded values, lo zero), kept under their own key beside its 3xTF32 planes;
a weight that a kernel stages itself (biases, norms, the attention's head slabs, B11's
fragments) goes as it is, and the kernel rounds it where its fragment is set.
``f32(w)`` is a weight's exact f32 copy for the kernels' small f32 operands (biases, norms,
depthwise taps); ``up(t)`` takes a plain version's bf16 input to f32 (f32 and f64 stay), and
``rnd(t, dtype)`` is the rounding that the plain versions apply where the TPU kernel casts an
intermediate to its bf16 operand dtype.

``MAX_ROW_K`` is the most rows of K that a row product stages at a time: ``kMmaMaxK`` of
``csrc/mma_f32x3.cuh``, what 128 rows of A leave of a block's shared memory beside the
weight ring. A wider K goes in the pieces that ``piece_sizes`` lists, as the kernels take it
(``tile_mma_piece``).

The row product of ``csrc/hat_rows.cu`` is persistent: ``row_grid`` gives its launches'
blocks, one an SM of the card (``sm_count``) and at most one a row tile of ``ROW_TILE``
pixels; block b walks the tiles b, b + grid, ...
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from ...utils import profiling

_HALF_ULP = 0x1000
_TF32_MASK = -0x2000   # 0xffffe000 as an int32
MAX_ROW_K = 192


#: The process-wide matmul operand dtype of the kernels (None: each call's storage dtype).
_OPERANDS = [None]


def operand_dtype(dtype: torch.dtype, mxu_dtype=None) -> torch.dtype:
    """The matmul operand dtype of a kernel call on storage `dtype`, as the JAX package's
    ``_mxu_dtype`` picks it: `mxu_dtype` where given, else float64 for a float64 reference
    (never rounded), else the process-wide dtype of ``operands``, else `dtype` itself. A
    bfloat16 storage has bf16 operands whatever is asked: its values are bf16 already."""
    if dtype == torch.bfloat16:
        return dtype
    if mxu_dtype is not None:
        return mxu_dtype
    if dtype == torch.float64 or _OPERANDS[0] is None:
        return dtype
    return _OPERANDS[0]


@contextlib.contextmanager
def operands(dtype):
    """Sets the process-wide operand dtype (torch.bfloat16 for precision "default", None
    for each call's storage dtype) and restores the one before on the way out."""
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"operands: expected None, float32 or bfloat16, got {dtype}")
    old, _OPERANDS[0] = _OPERANDS[0], dtype
    try:
        yield
    finally:
        _OPERANDS[0] = old


def piece_sizes(k: int) -> list[int]:
    """The rows of K (a multiple of 8) that the row products stage at a time: the fewest
    pieces of at most MAX_ROW_K, as even as multiples of 8 fall, the last taking the rest
    (``tile_mma_piece`` of ``csrc/mma_f32x3.cuh``)."""
    n = -(-k // MAX_ROW_K)
    piece = (-(-k // n) + 7) // 8 * 8
    return [min(piece, k - i) for i in range(0, k, piece)]


ROW_TILE = 128


def row_tiles(rows: int) -> int:
    """Row tiles of ROW_TILE pixels over `rows` rows, the last one ragged."""
    return -(-rows // ROW_TILE)


def row_grid(rows: int, sms: int) -> int:
    """Blocks of a persistent row-product launch over `rows` rows on a card of `sms` SMs: one
    an SM, at most one a row tile (and at least one)."""
    return max(1, min(sms, row_tiles(rows)))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of the card `device` (read once a card)."""
    device = torch.device(device)
    return _sms(torch.cuda.current_device() if device.index is None else device.index)


def split_tf32(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(w_hi, w_lo) of a float32 tensor: w_hi = TF32(w), rounded to nearest with ties away
    from zero, w_lo = w - w_hi (exact). Of a bfloat16 tensor: (w as float32, zeros), since
    TF32 holds every bf16 value."""
    if w.dtype == torch.bfloat16:
        hi = w.float()
        return hi, torch.zeros_like(hi)
    if w.dtype != torch.float32:
        raise ValueError(f"split_tf32: expected float32 or bfloat16, got {w.dtype}")
    hi = ((w.contiguous().view(torch.int32) + _HALF_ULP) & _TF32_MASK).view(torch.float32)
    return hi, w - hi


def padded(w: torch.Tensor, kp: int, npad: int) -> torch.Tensor:
    """w [K,N] zero-padded to [kp,npad]: the row products take K and N in multiples of 8
    (180 -> 184), and padded zeros change no product."""
    return F.pad(w, (0, npad - w.shape[1], 0, kp - w.shape[0]))


def mma_planes(wp: torch.Tensor) -> torch.Tensor:
    """wp [kp,npad] (multiples of 8) split into the B fragments of tile_mma:
    [kp/8, npad/8, 32, 4] float32 (see the module's docstring)."""
    kp, npad = wp.shape
    if kp % 8 or npad % 8:
        raise ValueError(f"mma_planes: [{kp},{npad}] is not padded to multiples of 8")
    hi, lo = split_tf32(wp)
    if wp.dtype == torch.float32:
        lo = (lo.view(torch.int32) + _HALF_ULP).view(torch.float32)
    return torch.cat([b_fragments(hi), b_fragments(lo)], dim=-1)


def b_fragments(wp: torch.Tensor) -> torch.Tensor:
    """wp [kp,npad] (multiples of 8) in the order of mma.sync.m16n8k8's B fragments, unsplit:
    [kp/8, npad/8, 32 = lane 4g + t, 2 = (wp[t][g], wp[t+4][g]) of its 8x8 tile], float32."""
    wp = wp.float()
    kp, npad = wp.shape
    if kp % 8 or npad % 8:
        raise ValueError(f"b_fragments: [{kp},{npad}] is not padded to multiples of 8")
    return wp.reshape(kp // 8, 2, 4, npad // 8, 8).permute(0, 3, 4, 2, 1).reshape(
        kp // 8, npad // 8, 32, 2).contiguous()


#: What ``kept`` made so far, on the tensor that owns each first argument's memory.
_KEPT = WeakTensorKeyDictionary()


def kept(spec: tuple, make, *ts: torch.Tensor):
    """make() for the tensors ts (a weight and, where it goes with one, its bias) and a
    hashable `spec` of what is made, once: the result is kept on the tensor that owns
    ts[0]'s memory (ts[0] itself, or the base of the view that it is, such as
    ``linear.weight.t()``) and goes when it goes. It is made anew when any of ts changes
    in place (its version counter), is viewed another way, or has its memory replaced
    (``module.to``, ``param.data = ...``): the entry holds the storage that each of ts had
    when it was made, and a hit needs the same storage, so that an address the allocator
    hands out again cannot pass for the old memory. There is one entry for each spec and
    view: a replaced entry goes, with the storage it held. An inference tensor counts no
    versions: for one, make() runs on every call. While a profiler is profiling, each
    make() is counted under ``weights_made`` by spec[0] (``utils/profiling.py``)."""
    for t in ts:
        if t.is_inference():
            profiling.count("weights_made", spec[0])
            return make()
    w = ts[0]
    root = w if w._base is None else w._base
    key = (spec, *[(t.shape, t.stride(), t.storage_offset(), t.device, t.dtype) for t in ts])
    storages = [t.untyped_storage() for t in ts]
    versions = [t._version for t in ts]
    table = _KEPT.get(root)
    if table is None:
        table = _KEPT[root] = {}
    hit = table.get(key)
    if (hit is None or hit[1] != versions
            or any(a._cdata != b._cdata for a, b in zip(hit[0], storages))):
        table.pop(key, None)   # the old entry and the memory it holds go first
        profiling.count("weights_made", spec[0])
        hit = table[key] = (storages, versions, make())
    return hit[2]


def bf16_planes(w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """w as the one-pass kernels take it at bf16 operands (`bf16`): its bf16 rounding where w
    is float32, whose ``mma_planes`` are then hi = the rounded values and lo = 0; else w."""
    return w.to(torch.bfloat16) if bf16 and w.dtype == torch.float32 else w


def planes(w: torch.Tensor, kp: int, npad: int, bf16: bool = False) -> torch.Tensor:
    """``mma_planes`` of w [K,N] zero-padded to [kp,npad], made once for each weight
    (``kept``); with `bf16` (precision "default": the kernel's code ``_build.io_code`` 2), those
    of its bf16 rounding, under a key of their own."""
    return kept(("planes", kp, npad, bf16),
                lambda: mma_planes(padded(bf16_planes(w, bf16), kp, npad)), w)


def fragments(w: torch.Tensor) -> torch.Tensor:
    """``b_fragments`` of w [K,N] (multiples of 8), made once for each weight (``kept``)."""
    return kept(("fragments",), lambda: b_fragments(w), w)


def f32(w: torch.Tensor) -> torch.Tensor:
    """w itself if it is float32, else its float32 copy, made once for each weight
    (``kept``): the kernels read their small operands (biases, norms, taps) in f32, and a
    bf16 weight's values are exact there."""
    if w.dtype == torch.float32:
        return w
    return kept(("f32",), lambda: w.float().contiguous(), w)


def up(t: torch.Tensor) -> torch.Tensor:
    """A bfloat16 tensor as float32 (exact); any other tensor as it is (a float64 reference
    stays float64)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def rnd(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to bfloat16 and back to float32 (float64 for a float64 t) where `dtype` is
    bfloat16: where the TPU kernel casts an intermediate or an operand to its operand dtype
    (``.astype(dt)``); t itself for any other dtype."""
    if dtype != torch.bfloat16:
        return t
    return t.to(dtype).to(torch.float64 if t.dtype == torch.float64 else torch.float32)
