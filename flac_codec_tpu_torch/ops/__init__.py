"""Device plane of the port: the batched encode planner and frame packer,
the decoder's inverse predictors and its frame-body parser on PyTorch
tensors, with the CUDA kernels behind ``packpanel``, ``lpc``,
``predict_pallas`` and ``framescan``."""

from . import decorrelate, fixed, lpc, rice  # noqa: F401
from .encode_batch import encode_frames_plan  # noqa: F401
