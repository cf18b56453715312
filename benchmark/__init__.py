"""The benchmark of ``flac_codec_tpu_torch`` (see ``BENCHMARK.json``)."""
