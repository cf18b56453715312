"""Orchestration plane of the port: frame batching, sharding over a device
list (``mesh.batch_mesh``), and the batch encode and decode pipelines."""

from .batch import BatchEncoder, assemble_frames  # noqa: F401
from .mesh import batch_mesh, shard_batch  # noqa: F401
