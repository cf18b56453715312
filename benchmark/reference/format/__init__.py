# Frozen copy of flac_codec_tpu_torch/format/__init__.py at commit be3fb28 (no native engine:
# its array paths are numpy here).  Do not edit to follow the program.
"""Stream/frame format layer (reference: src/stream.rs).

Field codecs for frame headers, subframe headers, residual partitions and the
structured whole-frame analysis model used by flac-analyze.
"""

from .frame import (  # noqa: F401
    BLOCK_SIZE_CODES,
    SAMPLE_RATE_CODES,
    BPS_CODES,
    ChannelAssignment,
    FrameHeader,
    MAX_FRAME_NUMBER,
    encode_frame_number,
    read_frame_number,
)
from .subframe import (  # noqa: F401
    FIXED_COEFFS,
    SubframeHeader,
    read_subframe_header,
)
