"""Twin of ``freqfusion_tpu/ops``: the shared numerical ops it exports. ``ops.resize`` stays
the module (the port's code and tests import it as one); its function is
``ops.resize.resize``."""

from .common import (channel_layernorm, pad_to_multiple, pixel_shuffle,  # noqa: F401
                     pixel_unshuffle, same_pad)
from .resize import downsample, upsample  # noqa: F401
