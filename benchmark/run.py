"""The benchmark of flac_codec_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See ``benchmark/harness/runner.py`` and ``BENCHMARK.json``."""

import os
import sys

# the checkout's root, not this directory, heads the import path
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
