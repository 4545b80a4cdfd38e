"""python3 -m bench_torch.calibrate --workload <cell> --seeds 1,2,3 --seconds 2

The readings that set a cell's limits, all seeds in one process: for each
seed a run of the cell's own set-up and load for `--seconds`, then each
compared number twice: the program against the reference (the lower
reading), and the control, the reference computed in bfloat16 in the
program's place, against the reference (the upper reading). One JSON line
a seed; the benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    from . import common

    if not torch.cuda.is_available():
        print("no CUDA card visible", file=sys.stderr)
        return 2
    wl = common.load_json("workloads", args.workload)
    cfg = common.load_json("configs", wl["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(wl, cfg, seed, args.seconds, "cuda")), flush=True)
    return 0


def readings(wl: dict, cfg: dict, seed: int, seconds: float, device) -> dict:
    """{"seed", "calls", "guarantees", "program": {number: value},
    "control": {...}, "largest": the largest |pos|, |vel|, |C| the program
    answered in the sampled calls}."""
    from . import common

    drv = common.load_module("drivers", wl["driver"]).Driver(wl, cfg, seed, device)
    drv.setup()
    win = drv.loop(seconds=seconds)
    guarantees = {c.name: c.value for c in drv.guarantees()}
    drv.release()
    program = drv.gaps()
    control = drv.gaps(control=True)
    scale = {k: max(float(kept[5 + i].float().abs().max()) for kept in drv.samples.items)
             for i, k in enumerate(("pos", "vel", "C"))}
    return {"seed": seed, "calls": win["calls"], "guarantees": guarantees, "program": program,
            "control": control, "largest": scale}


if __name__ == "__main__":
    sys.exit(main())
