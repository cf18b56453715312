"""The benchmark's plain reference codec against the port's host codec,
on a few seeded frames (CPU)."""

import io

import numpy as np
import pytest

from benchmark.harness import audio, pool, tracks
from benchmark.reference import crc as ref_crc
from benchmark.reference import decode as ref_decode
from benchmark.reference import encode as ref_encode
from flac_codec_tpu_torch import crc as port_crc
from flac_codec_tpu_torch import decode as port_decode
from flac_codec_tpu_torch import encode as port_encode

CD = dict(sample_rate=44100, bits_per_sample=16, channels=2,
          block_size=4096, max_lpc_order=12, max_partition_order=6,
          mid_side=True, window=["tukey", 0.5],
          exhaustive_channel_correlation=True, padding=4096,
          seektable_seconds=10)
HIRES = dict(CD, sample_rate=96000, bits_per_sample=24)


def clip(cfg, seconds, seed, wasted=0, lead=0.0, tail=0.0):
    pcm = audio.music(seconds, cfg["sample_rate"], cfg["bits_per_sample"],
                      seed, "cpu", lead_s=lead, tail_s=tail,
                      wasted_bits=wasted)
    return tracks.interleaved(pcm)


def sequential(mod, cfg, x):
    buf = io.BytesIO()
    w = mod.FlacSampleWriter(buf, pool.options(mod.Options, cfg),
                             cfg["sample_rate"], cfg["bits_per_sample"],
                             cfg["channels"], len(x) // cfg["channels"])
    w.write(x)
    w.finalize()
    return buf.getvalue()


CASES = [("cd", CD, 0, 0.0, 0.0), ("cd-silent-ends", CD, 0, 0.2, 0.3),
         ("hires", HIRES, 0, 0.0, 0.0), ("hires-wasted8", HIRES, 8, 0.1, 0.2)]


@pytest.mark.parametrize("name,cfg,wasted,lead,tail", CASES,
                         ids=[c[0] for c in CASES])
def test_reference_encoder_matches_port_host_encoder(name, cfg, wasted,
                                                     lead, tail):
    x = clip(cfg, 0.6, 11, wasted, lead, tail)
    assert sequential(ref_encode, cfg, x) == sequential(port_encode, cfg, x)


@pytest.mark.parametrize("name,cfg,wasted,lead,tail", CASES,
                         ids=[c[0] for c in CASES])
def test_parallel_reference_matches_sequential(name, cfg, wasted, lead,
                                               tail):
    x = clip(cfg, 0.7, 12, wasted, lead, tail)
    stream, layout = pool.encode_reference(x, cfg, workers=3)
    assert stream == sequential(ref_encode, cfg, x)
    total = len(x) // cfg["channels"]
    assert layout["frames"] == total // cfg["block_size"]
    assert layout["tail_samples"] == total % cfg["block_size"]
    assert layout["stream_bytes"] == len(stream)


@pytest.mark.parametrize("cfg", [CD, HIRES], ids=["cd", "hires"])
def test_reference_stream_decodes_to_its_source(cfg):
    x = clip(cfg, 0.2, 13, 0, 0.02, 0.05)
    stream, _ = pool.encode_reference(x, cfg, workers=2)
    for mod in (ref_decode, port_decode):
        with mod.FlacSampleReader(io.BytesIO(stream)) as r:
            got = r.read(len(x))
        np.testing.assert_array_equal(np.asarray(got), x)


@pytest.mark.parametrize("n", [0, 1, 7, 63, 64, 65, 4097, 9001])
def test_numpy_crc_matches_port(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    for crc in (0, 1, 0x1234, 0xFFFF):
        assert ref_crc.crc16(data, crc) == port_crc.crc16(data, crc)
        assert ref_crc.crc8(data, crc & 0xFF) == port_crc.crc8(data, crc & 0xFF)


def test_signal_is_the_frozen_chip_smoke_music():
    """The chords are ``chip_smoke.music``'s (drawn in its order); only
    the noise floor (from another generator) differs, so the two tracks
    differ by about that noise alone: a few % of the signal's spread."""
    import chip_smoke

    for seed in (5, 21):
        want = chip_smoke.music(2.0, 44100, 16, seed).reshape(-1, 2)
        got = tracks.interleaved(audio.music(2.0, 44100, 16, seed, "cpu"))
        got = got.reshape(-1, 2).astype(np.float64)
        for c in range(2):
            assert np.corrcoef(got[:, c], want[:, c])[0, 1] > 0.999
        assert (got - want).std() < 0.06 * want.std()
