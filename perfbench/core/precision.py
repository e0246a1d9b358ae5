"""What a configuration's numerics are, from its ``dtype`` and ``precision``: the rounding of
the check's control, the tensor-core peak of its products, and the bytes of an element it
stores.

* float32 at ``highest`` (TF32 off): f32-exact products; the control rounds their operands to
  TF32, the peak is TF32's (495 TFLOP/s), elements are 4 bytes.
* float32 at ``default``: f32 storage, every product on operands rounded to bf16 (the
  program's default numerics); the control rounds to fp8 e4m3, the peak is bf16's
  (989 TFLOP/s), elements are 4 bytes.
* bfloat16 at ``highest``: bf16 storage and products; the control rounds to fp8 e4m3, the
  peak is bf16's, elements are 2 bytes.

Peaks are those of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit).
"""

from __future__ import annotations

from typing import NamedTuple


class Numerics(NamedTuple):
    control: str          # the control's rounding (``reference/ops.ROUNDINGS``)
    tensor_core: float    # FLOP/s of the products on the tensor cores
    element_bytes: int    # bytes of a stored element


TF32_PEAK, BF16_PEAK = 495e12, 989e12
_TABLE = {("float32", "highest"): Numerics("tf32", TF32_PEAK, 4),
          ("float32", "default"): Numerics("fp8_e4m3", BF16_PEAK, 4),
          ("bfloat16", "highest"): Numerics("fp8_e4m3", BF16_PEAK, 2)}


def numerics(dtype: str, precision: str = "highest") -> Numerics:
    """The numerics of a configuration served in `dtype` at `precision`."""
    try:
        return _TABLE[dtype, precision]
    except KeyError:
        raise ValueError(f"no numerics for dtype {dtype!r} at precision {precision!r}; "
                         f"known: {sorted(_TABLE)}") from None
