"""flac-analyze — `flac -a` equivalent (reference: examples/flac-analyze.rs).
Dumps per-frame/subframe structure via the analysis types.
"""

from __future__ import annotations

import argparse

from ..format.analyze import FrameIterator


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="flac-analyze")
    p.add_argument("input")
    args = p.parse_args(argv)

    with open(args.input, "rb") as fp:
        it = FrameIterator(fp)
        sample = 0
        for num, (frame, offset) in enumerate(it):
            h = frame.header
            print(f"frame={num}\toffset={offset}\tbits={frame.byte_size * 8}"
                  f"\tblocksize={h.block_size}\tsample_rate={h.sample_rate}"
                  f"\tchannels={h.channel_count}"
                  f"\tchannel_assignment={h.channel_assignment:#06b}")
            for ch, sub in enumerate(frame.subframes):
                extra = ""
                if sub.type == "lpc":
                    extra = (f"\tqlp_coeff_precision={sub.precision}"
                             f"\tquantization_level={sub.shift}")
                if sub.partition_order is not None:
                    extra += f"\tpartition_order={sub.partition_order}"
                print(f"\tsubframe={ch}\ttype={sub.type.upper()}"
                      f"\torder={sub.order}\twasted_bits={sub.wasted_bps}"
                      f"{extra}")
                for pi, part in enumerate(sub.partitions):
                    print(f"\t\tpartition={pi}\tkind={part.kind}"
                          f"\tparameter={part.parameter}"
                          f"\tsamples={part.sample_count}")
            sample += h.block_size
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
