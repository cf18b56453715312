# Frozen copy of flac_codec_tpu_torch/models/__init__.py at commit be3fb28 (no native engine:
# its array paths are numpy here).  Do not edit to follow the program.
"""Predictor model family: FIXED (orders 0-4) and LPC (orders 1-32).

Host (numpy, f64) reference implementations of the numeric kernels, pinned by
golden vectors from the reference implementation (SURVEY §4 tier 1).  The
batched device versions in ``ops/`` are validated against these.
"""

from .fixed import best_fixed_order, fixed_diffs  # noqa: F401
from .lpc import (  # noqa: F401
    LpcParameters,
    autocorrelate,
    compute_best_order,
    lp_coefficients,
    precision_for_block_size,
    quantize,
    window,
)
