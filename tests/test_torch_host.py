"""The port's own host plane, held to the JAX package's.

``flac_codec_tpu_torch`` carries a copy of the host modules it needs
(``encode``, ``decode``, ``metadata``, ``format``, ``models``, ``bitio``,
``crc``, ``native``...), so that it imports nothing of ``flac_codec_tpu``.
These tests pin the copy to the original: the same samples and options
give the same FLAC bytes, and the same stream decodes to the same
samples.  They also hold the port's native loader to its rules: a
portable build that fails raises, with the compiler's output; the
``-march=x86-64-v3`` flavor loads on a v3 host unless
``FLAC_TPU_PORTABLE_SO`` is set, and a v3 build that fails loads the
portable library and says so; both flavors give the same bytes and
samples.
"""

import collections
import concurrent.futures
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
from flac_codec_tpu_torch.parallel.batch import BatchEncoder
from flac_codec_tpu_torch.parallel.batch_decode import BatchDecoder


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


FLAVORS = ("portable", "v3")


@pytest.fixture
def v3_cpu():
    if not native._cpu_is_v3():
        pytest.skip("this CPU cannot run the x86-64-v3 build")


@pytest.fixture(scope="module")
def flavor_build(tmp_path_factory):
    """Both native flavors, built once (in parallel) into a directory of
    the module's: (the directory, {flavor: Native}); the v3 library is
    opened only on a CPU that can run it."""
    build = str(tmp_path_factory.mktemp("native"))
    flavors = FLAVORS if native._cpu_is_v3() else FLAVORS[:1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "BUILD", build)
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            libs = dict(zip(flavors, ex.map(native.open_flavor, flavors)))
    return build, libs


def _load(monkeypatch, build, v3_host, portable_env):
    """``native.load()`` afresh with the host's level and the variable
    as given; returns the path of the library it loaded."""
    for name, value in (("_lib", None), ("FLAVOR", None),
                        ("V3_ERROR", None), ("BUILD", build)):
        monkeypatch.setattr(native, name, value)
    monkeypatch.setattr(native, "_cpu_is_v3", lambda: v3_host)
    if portable_env:
        monkeypatch.setenv("FLAC_TPU_PORTABLE_SO", "1")
    else:
        monkeypatch.delenv("FLAC_TPU_PORTABLE_SO", raising=False)
    return native.load()._lib._name


def _flavor_path(flavor):
    return native._build(native.GXX_FLAGS + (
        native.V3_FLAGS if flavor == "v3" else ()))


def test_native_loads_v3_flavor_on_v3_host(v3_cpu, flavor_build,
                                           monkeypatch):
    build, _ = flavor_build
    path = _load(monkeypatch, build, v3_host=True, portable_env=False)
    assert (native.FLAVOR, native.V3_ERROR) == ("v3", None)
    assert path == _flavor_path("v3") != _flavor_path("portable")


@pytest.mark.parametrize("v3_host,portable_env",
                         [(True, True), (False, False), (False, True)])
def test_native_loads_portable_flavor(flavor_build, monkeypatch, v3_host,
                                      portable_env):
    """``FLAC_TPU_PORTABLE_SO`` set, or a host below x86-64-v3: the
    portable library."""
    build, _ = flavor_build
    path = _load(monkeypatch, build, v3_host, portable_env)
    assert (native.FLAVOR, native.V3_ERROR) == ("portable", None)
    assert path == _flavor_path("portable")


def test_native_v3_build_failure_loads_portable(flavor_build, monkeypatch):
    """A v3 build that fails loads the portable library, with a warning
    and the compiler's output in ``V3_ERROR``."""
    build, _ = flavor_build
    monkeypatch.setattr(native, "V3_FLAGS",
                        ("-march=x86-64-v3", "--no-such-flag"))
    with pytest.warns(RuntimeWarning, match="no-such-flag"):
        path = _load(monkeypatch, build, v3_host=True, portable_env=False)
    assert native.FLAVOR == "portable"
    assert "no-such-flag" in native.V3_ERROR
    assert path == _flavor_path("portable")


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


class _BothFlavors:
    """Stands in for the loaded engine: ``parse_frames_raw``,
    ``decode_frames`` and ``assemble_packed`` run in both flavors on the
    same inputs, and must give the same results."""

    COMPARED = ("parse_frames_raw", "decode_frames", "assemble_packed")

    def __init__(self, libs):
        self.libs = libs
        self.calls = collections.Counter()

    def __getattr__(self, name):
        fn = getattr(self.libs["portable"], name)
        if name not in self.COMPARED:
            return fn

        def both(*args, **kw):
            got = fn(*args, **kw)
            if isinstance(kw.get("out"), np.ndarray):   # a buffer of its own
                kw["out"] = np.empty_like(kw["out"])
            _assert_same(got, getattr(self.libs["v3"], name)(*args, **kw),
                         name)
            self.calls[name] += 1
            return got

        return both


@pytest.mark.parametrize("case", sorted(_CASES))
def test_native_flavors_give_the_same_bytes_and_samples(case, v3_cpu,
                                                        flavor_build,
                                                        monkeypatch):
    """Each case through the port's ``BatchEncoder`` (frame assembly),
    ``BatchDecoder`` (raw parse) and ``FlacSampleReader`` (bulk decode)
    on the CPU, with every call of the three engine functions run in
    both flavors."""
    opts, rate, bps, channels, n, kind, with_total = _CASES[case]
    inter = _signal(np.random.default_rng(len(case) * 7), n, channels, bps,
                    kind)
    both = _BothFlavors(flavor_build[1])
    monkeypatch.setattr(native, "_lib", both)
    buf = io.BytesIO()
    enc = BatchEncoder(buf, _options(tencode, opts), rate, bps, channels,
                       total_samples=n if with_total else None,
                       batch_frames=4, analysis="f64", device="cpu")
    enc.write(inter)
    enc.finalize()
    data = buf.getvalue()
    assert data == _encode(tencode, case, inter)
    with BatchDecoder(io.BytesIO(data), 4, device="cpu") as dec:
        got = dec.read_all_device().numpy().reshape(-1)
    np.testing.assert_array_equal(got, inter)
    with tdecode.FlacSampleReader(io.BytesIO(data)) as r:
        np.testing.assert_array_equal(r.read_to_end(), inter)
    assert all(both.calls[name] for name in both.COMPARED), both.calls


@pytest.mark.parametrize("module,least", [(tencode, 12), (tdecode, 10),
                                          (tmetadata, 5)])
def test_copied_docstring_examples_run(module, least):
    """The copies' docstring examples name the port and still run."""
    r = doctest.testmod(module, verbose=False)
    assert r.attempted >= least and r.failed == 0, r
