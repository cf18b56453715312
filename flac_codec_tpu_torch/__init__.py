"""flac_codec_tpu_torch — the batched FLAC encode and decode paths on
PyTorch and CUDA.

A port of ``flac_codec_tpu``'s device plane (the JAX/Pallas planner,
frame packer and decoder reconstruction) to PyTorch, with the Pallas
kernels of those paths rewritten as CUDA C++ for Hopper (``csrc/``).

The port stands alone: it imports neither ``jax`` nor any module of
``flac_codec_tpu``.  It carries its own copy of the host plane
(``encode``, ``decode``, ``metadata``, ``format``, ``models``, ``bitio``,
``crc``, ``byteorder``, ``rice``, ``errors``, ``utils.wav``) and of the
native C++ engine (``native/``), which it builds at first use and
requires.  Only the tests hold the port against the JAX package.

Layout mirrors the JAX package so a reader finds each counterpart:
``ops/`` (planner, packers, inverse predictors), ``parallel/batch.py``
(``BatchEncoder``), ``parallel/batch_decode.py`` (``BatchDecoder``),
``cli/`` (``wav2flac``, ``flac2wav``) and ``convert.py`` (plan trees
between the two).  ``graphs.py`` is the counterpart of ``jax.jit``: the
CUDA graph capture that the encoder and the decoder replay per batch.

The public surface is the JAX package's: ``errors``, ``FlacError`` and,
loaded at first use, the readers, the writers, ``verify``, ``Options``,
``generate_seektable``, ``BlockList`` and ``Streaminfo``.
"""

from . import errors  # noqa: F401
from .errors import FlacError  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # The JAX package's lazy exports, name for name, each resolved to the
    # port's own object; importing the package builds nothing.
    import importlib

    api = {
        "FlacByteReader": ".decode",
        "FlacSampleReader": ".decode",
        "FlacChannelReader": ".decode",
        "FlacStreamReader": ".decode",
        "verify": ".decode",
        "FlacByteWriter": ".encode",
        "FlacSampleWriter": ".encode",
        "FlacChannelWriter": ".encode",
        "FlacStreamWriter": ".encode",
        "Options": ".encode",
        "generate_seektable": ".encode",
        "BlockList": ".metadata",
        "Streaminfo": ".metadata",
    }
    if name in api:
        mod = importlib.import_module(api[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
