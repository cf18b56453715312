"""Build the JAX package's native engine once, before any test collects.

``flac_codec_tpu.native.load()`` builds ``libflacnat_v3.so`` (and rebuilds
the committed ``libflacnat.so`` when it looks older than its source) in
place, through one fixed temporary name and with no lock across
processes, and a process keeps a failed load for its life.  Under
``pytest -n N`` every worker imports the modules that load it at
collection, at the same moment, and a worker that loads a half-written
library runs without the reference: its modules skip and the tests that
hold the port to it fail.  So the controller loads it first, under a
lock, and every worker finds fresh libraries and builds nothing.

The load runs in a child process: the benchmark's tests run its harness
in process, and the harness refuses to run with ``flac_codec_tpu``
loaded.  A failed build is not an error here; the tests that need the
reference fail on it.
"""

import fcntl
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def pytest_configure(config):
    if hasattr(config, "workerinput"):      # an xdist worker
        return
    # another pytest session on this checkout waits for the build
    with open(__file__) as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run([sys.executable, "-c",
                        "from flac_codec_tpu import native; native.load()"],
                       cwd=ROOT, check=False)
