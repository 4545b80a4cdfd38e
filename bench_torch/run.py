"""python3 -m bench_torch.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json on the card and prints its result as the
last line of standard output. Exits 2, printing no result, without a card
or with fewer cards than the cell asks for."""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import common, harness

    torch.set_num_threads(1)  # one host thread: the card's work is queued from it alone

    wl = common.load_json("workloads", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                           wl=wl)
    harness.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
