"""``mx.contrib.amp``: the top-level AMP module under the reference's old
import path."""

from ..amp import (  # noqa: F401
    LossScaler,
    convert_hybrid_block,
    convert_model,
    init,
    init_trainer,
    is_enabled,
    scale_loss,
    unscale,
)
