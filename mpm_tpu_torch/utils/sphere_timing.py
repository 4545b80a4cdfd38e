"""Times the port's loops with the CLI's force spheres on one card, so that
one checkout can be held against another where they differ in how the
spheres reach kernel F:

- F: kernel F (ops/cuda/g2p_migrate) alone on fluid_3d (157,464 particles,
  64^3, K=16, float32) after 20 substeps, with no sphere and with the CLI's
  three (--interact sphere=32,10,32,6 --interact sphere=8,70,56,5,0.5
  --orbit-sphere): 100 calls each, by CUDA events and by the host's clock
  (fenced at the end);
- steps: 3 windows of 100 substeps of make_step(mode="cuda") in chunks of
  10, with no sphere and with the three, the orbit sphere moved each chunk;
- frames: 7 windows of 40 frames of the 640x360 render loop under the orbit
  camera, with no sphere, with the three and the fly pointer's inactive
  sphere (what `render --fly` passes each substep), and with those four held
  still (the orbit sphere of frame 0), the three in turns after a warm-up
  window each;
- rows (where the checkout has ops/interact.interaction_rows): microseconds
  a call for the four, moving (new values each call) and still.

    python mpm_tpu_torch/utils/sphere_timing.py [--root CHECKOUT]

--root: the checkout whose mpm_tpu_torch is timed (default: the one holding
this file). Run it from two checkouts in turns (A, B, B, A) within one
session on the card to compare them. Prints one JSON line with the card's
name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


WINDOWS = 7


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args()
    sys.path[0] = str(Path(args.root).resolve())  # not this file's folder

    import torch

    import mpm_tpu_torch
    from mpm_tpu_torch.__main__ import _camera, _parse_interactions
    from mpm_tpu_torch.models.scenes import fluid_3d
    from mpm_tpu_torch.ops import bucketed
    from mpm_tpu_torch.ops.cuda import g2p_migrate as kf
    from mpm_tpu_torch.ops.cuda import p2g_update as kp
    from mpm_tpu_torch.ops.step import make_step
    from mpm_tpu_torch.render import Camera, RenderConfig
    from mpm_tpu_torch.render.flycam import SpherePointer
    from mpm_tpu_torch.render.pipeline import make_full_frame_step
    from mpm_tpu_torch.utils.timing import cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    sc = fluid_3d(device="cuda")
    cfg, fluid = sc.config, sc.fluid
    cli = argparse.Namespace(interact=["sphere=32,10,32,6", "sphere=8,70,56,5,0.5"],
                             orbit_sphere=True)
    inter_fn = _parse_interactions(cli, cfg)[1]
    pointer = SpherePointer(cfg).interaction()
    sets = {"none": lambda i: (), "three": inter_fn}

    state = bucketed.from_simstate(sc.state, cfg)
    chunk = make_step(cfg, mode="cuda", substeps=10)
    state = chunk(chunk(state, fluid), fluid)
    grid = kp.p2g_update(state, cfg, fluid)
    out = {"root": str(Path(mpm_tpu_torch.__file__).parent.parent), "card": card,
           "F_ms": {}, "F_host_ms": {}, "steps_ms": {}, "frames_ms": {}}
    for name, fn in sets.items():
        inter = fn(7)
        call = lambda: kf.g2p_migrate(state, grid, cfg, fluid, inter)  # noqa: E731
        out["F_ms"][name] = cuda_time_ms(call, 100, warmup=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            call()
        torch.cuda.synchronize()
        out["F_host_ms"][name] = (time.perf_counter() - t0) * 10.0
    del grid

    for name, fn in sets.items():
        s, wins = state, []
        for _ in range(4):  # the first window warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(10):
                s = chunk(s, fluid, fn(i))
            torch.cuda.synchronize()
            wins.append((time.perf_counter() - t0) * 1e3 / 100)
        out["steps_ms"][name] = wins[1:]

    view_fn = _camera(argparse.Namespace(fly=False, fly_script=None, orbit_camera=True,
                                         frames=120), sc)[0]
    frame = make_full_frame_step(cfg, RenderConfig(camera=Camera(width=640, height=360)),
                                 cfg.substeps)
    fixed = inter_fn(0) + (pointer,)
    frame_sets = {"none": lambda i: (), "four": lambda i: inter_fn(i) + (pointer,),
                  "four_still": lambda i: fixed}
    states = {name: state for name in frame_sets}
    for name in frame_sets:  # a warm-up window each
        for i in range(40):
            states[name], _ = frame(states[name], fluid, frame_sets[name](i), view_fn(i), None)
    out["frames_ms"] = {name: [] for name in frame_sets}
    for _ in range(WINDOWS):  # the sets in turns, so that drift falls on all alike
        for name, fn in frame_sets.items():
            s = states[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(40):
                s, _ = frame(s, fluid, fn(i), view_fn(i), None)
            torch.cuda.synchronize()
            out["frames_ms"][name].append((time.perf_counter() - t0) * 1e3 / 40)
            states[name] = s
    for name, s in states.items():
        if int(s.lost) != 0:
            raise AssertionError(f"frames with {name}: lost {int(s.lost)}")

    from mpm_tpu_torch.ops import interact

    if hasattr(interact, "interaction_rows"):  # the spheres' device array
        for name, at in (("moving", lambda i: i), ("still", lambda i: 0)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(200):
                interact.interaction_rows(inter_fn(at(i)) + (pointer,), 3, "cuda")
            torch.cuda.synchronize()
            out.setdefault("rows_us", {})[name] = (time.perf_counter() - t0) * 1e6 / 200
    print(json.dumps(out))


if __name__ == "__main__":
    main()
