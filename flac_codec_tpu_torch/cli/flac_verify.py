"""flac-verify — `flac -t` equivalent (reference: examples/flac-verify.rs).
Verifies each file's full decode + MD5 in parallel processes (the
reference uses rayon par_iter, flac-verify.rs:42-47).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os


def _verify_one(path: str) -> tuple:
    from ..decode import verify
    from ..errors import FlacError

    try:
        return path, verify(path).value
    except FlacError as e:
        return path, f"error: {type(e).__name__}: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flac-verify")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-j", "--jobs", type=int, default=os.cpu_count())
    args = p.parse_args(argv)

    failed = 0
    if len(args.inputs) == 1:
        results = [_verify_one(args.inputs[0])]
    else:
        with concurrent.futures.ProcessPoolExecutor(args.jobs) as ex:
            results = list(ex.map(_verify_one, args.inputs))
    for path, result in results:
        print(f"{path}: {result}")
        if result != "md5-match" and result != "no-md5":
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
