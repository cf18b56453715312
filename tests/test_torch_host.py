"""The port's own host plane, held to the JAX package's.

``flac_codec_tpu_torch`` carries a copy of the host modules it needs
(``encode``, ``decode``, ``metadata``, ``format``, ``models``, ``bitio``,
``crc``, ``native``...), so that it imports nothing of ``flac_codec_tpu``.
These tests pin the copy to the original: the same samples and options
give the same FLAC bytes, and the same stream decodes to the same
samples.  They also hold the port's native loader to its rule: a build
that fails raises, with the compiler's output.
"""

import doctest
import io

import numpy as np
import pytest

from flac_codec_tpu import decode as jdecode
from flac_codec_tpu import encode as jencode
from flac_codec_tpu_torch import decode as tdecode
from flac_codec_tpu_torch import encode as tencode
from flac_codec_tpu_torch import metadata as tmetadata
from flac_codec_tpu_torch import native


def _signal(rng, n, channels, bps, kind):
    full = 1 << (bps - 1)
    if kind == "noise":
        return rng.integers(-full, full, n * channels).astype(np.int32)
    t = np.arange(n)
    amp = full >> 2
    x = np.stack([amp * np.sin(t * (0.012 + 0.005 * c))
                  + rng.integers(-(amp >> 5) - 1, (amp >> 5) + 1, n)
                  for c in range(channels)]).T
    if kind == "wasted":
        x = (x.astype(np.int64) >> 3) << 3
    return x.reshape(-1).astype(np.int32)


def _options(mod, name):
    O = mod.Options
    return {
        "default": O(),
        "fast": O.fast(),
        "best": O.best(),
        "block576": O(block_size=576),
        "lpc32": O.best().with_block_size(2048).with_max_lpc_order(32),
        "lpc1": O().with_max_lpc_order(1),
        "no_padding": O.best().no_padding().no_seektable(),
        "tagged": O().tag("TITLE", "t").tag("ARTIST", "a"),
    }[name]


# name: (options, rate, bps, channels, samples, signal, total known)
_CASES = {
    "default_stereo16": ("default", 44100, 16, 2, 4096 * 3 + 100, "music",
                         True),
    "fast_stereo16": ("fast", 44100, 16, 2, 4096 * 2 + 7, "music", True),
    "best_stereo16": ("best", 44100, 16, 2, 4096 * 3, "music", True),
    "best_stereo24": ("best", 96000, 24, 2, 4096 * 2 + 1000, "music", True),
    "default_mono8": ("default", 22050, 8, 1, 4096 + 300, "music", True),
    "block576_stereo20": ("block576", 48000, 20, 2, 576 * 7 + 11, "music",
                          True),
    "lpc32_stereo16": ("lpc32", 44100, 16, 2, 2048 * 4, "music", True),
    "lpc1_six16": ("lpc1", 48000, 16, 6, 4096 + 17, "music", True),
    "default_stereo32": ("default", 96000, 32, 2, 4096 + 5, "music", True),
    "default_noise16": ("default", 44100, 16, 2, 4096 * 2, "noise", True),
    "wasted_stereo16": ("default", 44100, 16, 2, 4096 * 2, "wasted", True),
    "no_padding_unknown": ("no_padding", 44100, 16, 2, 4096 * 2 + 9,
                           "music", False),
    "tagged_mono24": ("tagged", 48000, 24, 1, 4096 + 64, "music", True),
}


def _encode(mod, case, inter):
    opts, rate, bps, channels, n, _, with_total = _CASES[case]
    buf = io.BytesIO()
    enc = mod.FlacSampleWriter(buf, _options(mod, opts), rate, bps, channels,
                               total_samples=n if with_total else None)
    enc.write(inter)
    enc.finalize()
    return buf.getvalue()


@pytest.mark.parametrize("case", sorted(_CASES))
def test_sample_writer_bytes_match_jax_package(case):
    _, _, bps, channels, n, kind, _ = _CASES[case]
    inter = _signal(np.random.default_rng(len(case) * 7), n, channels, bps,
                    kind)
    port = _encode(tencode, case, inter)
    assert port == _encode(jencode, case, inter)
    with tdecode.FlacSampleReader(io.BytesIO(port)) as r:
        np.testing.assert_array_equal(r.read_to_end(), inter)


@pytest.mark.parametrize("case", ["best_stereo24", "lpc1_six16",
                                  "default_stereo32", "wasted_stereo16"])
def test_decoder_samples_match_jax_package(case):
    _, _, bps, channels, n, kind, _ = _CASES[case]
    inter = _signal(np.random.default_rng(3), n, channels, bps, kind)
    data = _encode(jencode, case, inter)
    port, ref = tdecode.Decoder(io.BytesIO(data)), \
        jdecode.Decoder(io.BytesIO(data))
    assert port.streaminfo.md5 == ref.streaminfo.md5
    while True:
        a, b = port.read_frame(), ref.read_frame()
        if a is None or b is None:
            assert a is None and b is None
            break
        np.testing.assert_array_equal(a, b)
    assert tdecode.verify(io.BytesIO(data)) is tdecode.Verified.MD5_MATCH


def test_native_build_failure_raises_with_compiler_output(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD", str(tmp_path))
    monkeypatch.setattr(native, "GXX_FLAGS",
                        ("-O3", "-shared", "-fPIC", "--no-such-flag"))
    with pytest.raises(RuntimeError, match="no-such-flag"):
        native.load()
    assert not list(tmp_path.rglob("*.so"))


@pytest.mark.parametrize("module,least", [(tencode, 12), (tdecode, 10),
                                          (tmetadata, 5)])
def test_copied_docstring_examples_run(module, least):
    """The copies' docstring examples name the port and still run."""
    r = doctest.testmod(module, verbose=False)
    assert r.attempted >= least and r.failed == 0, r
