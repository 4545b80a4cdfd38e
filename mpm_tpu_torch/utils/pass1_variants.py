"""Times kernel P's pass 1 (csrc/bucket_kernels.cuh, p2g_mass_tile) beside
variants of its source, on one CUDA card: the sharded stage 1 (p2g1_shard)
on slab 1 of 4 of config 5's settled unsharded window (utils/profile_shard's
scene, 150 substeps), and kernel A (p2g1_planes) on fluid_3d 64^3 K=16 f32
after 3 plain substeps. Every variant's grids must equal the first tree's
bit for bit; each is timed with CUDA events (50 launches) in turns, first to
last, then last to first. nvcc's registers and spills of each tree's pass-1
kernels are printed.

    python -m mpm_tpu_torch.utils.pass1_variants [--tree NAME=CSRC_DIR ...]

The trees: any given with --tree (a copy of mpm_tpu_torch/csrc, such as the
parent commit's from `git archive`), this checkout's csrc ("this"), and the
variants of VARIANTS, each this checkout's csrc with one edit. Builds go to
mpm_tpu_torch/_build/variants. Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..models.scenes import fluid_3d
from ..ops import bucketed
from ..ops.cuda import build
from ..ops.cuda.p2g_update import params_for
from ..parallel import domain
from .profile_shard import SLABS, config5_windows, settle
from .timing import cuda_time_ms

BUILD = build.BUILD_DIR / "variants"

_TILE = "return D == 3 ? (a == 0 ? 2 : a == 1 ? 8 : 16) : (a == 0 ? 8 : 32);"
_PREFETCH = """      SlotVals<D, VC> nx;
      nx.load(pos, vel, Cm, mass, (size_t)(k0 + slot_first(occ)) * g.C + b, KC);
      while (occ) {
        const SlotVals<D, VC> sv = nx;
        occ &= occ - 1;
        if (occ) nx.load(pos, vel, Cm, mass, (size_t)(k0 + slot_first(occ)) * g.C + b, KC);
"""
_NO_PREFETCH = """      for (; occ; occ &= occ - 1) {
        SlotVals<D, VC> sv;
        sv.load(pos, vel, Cm, mass, (size_t)(k0 + slot_first(occ)) * g.C + b, KC);
"""
_RMW = """          for (int z = 0; z < 3; ++z) {
            if (!((reach[D - 1] >> z) & 1u)) continue;
            r[D - 1] = z;
            const float mass_c = (wl * aw[D - 1][z]) * m;  // tap_weight, times the mass
            int n = 0, tn = 0;  // the node in the tile; its tap 2 - r
            for (int a = 0; a < D; ++a) {
              n = n * tile_dim<D>(a) + hc[a] + r[a] - 2;
              tn = tn * 3 + 2 - r[a];
            }
            V4 u = part[tn * NN + n];
            u.x = G::add(u.x, G::enc(mass_c, mult));
            for (int a = 0; a < D; ++a)  // matvec_row, then v + C * dist
              vec_at(u, a + 1) =
                  G::add(vec_at(u, a + 1), G::enc(mass_c * (v[a] + (cl[a] + cz[a][z])), mult));
            part[tn * NN + n] = u;
          }"""
_GUARDED_RMW = """          for (int z = 0; z < 3; ++z) {
            r[D - 1] = z;
            GT add[D + 1];
            const float mass_c = (wl * aw[D - 1][z]) * m;
            add[0] = G::enc(mass_c, mult);
            for (int a = 0; a < D; ++a)
              add[a + 1] = G::enc(mass_c * (v[a] + (cl[a] + cz[a][z])), mult);
            int n = 0, tn = 0;
            for (int a = 0; a < D; ++a) {
              n = n * tile_dim<D>(a) + hc[a] + r[a] - 2;
              tn = tn * 3 + 2 - r[a];
            }
            if ((reach[D - 1] >> z) & 1u) {
              V4 u = part[tn * NN + n];
              for (int e = 0; e <= D; ++e) vec_at(u, e) = G::add(vec_at(u, e), add[e]);
              part[tn * NN + n] = u;
            }
          }"""

# name: (text in bucket_kernels.cuh, its replacement)
VARIANTS = {
    # tiles of 4 x 4 x 16 and 4 x 8 x 8 nodes (both passes' tile_dim)
    "tile4x4x16": (_TILE, "return D == 3 ? (a == 2 ? 16 : 4) : (a == 0 ? 8 : 32);"),
    "tile4x8x8": (_TILE, "return D == 3 ? (a == 0 ? 4 : 8) : (a == 0 ? 8 : 32);"),
    # each slot loaded just before it is added, not while the one before is
    "no_prefetch": (_PREFETCH, _NO_PREFETCH),
    # the last axis's three taps computed alike, only the read-modify-write
    # of the partial guarded
    "guarded_rmw": (_RMW, _GUARDED_RMW),
}


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _trees(extra: list[str]) -> dict[str, Path]:
    trees = {}
    for spec in extra:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    trees["this"] = build.CSRC
    for name, (old, new) in VARIANTS.items():
        src = (build.CSRC / "bucket_kernels.cuh").read_text()
        if old not in src:
            raise RuntimeError(f"variant {name}: its text is not in bucket_kernels.cuh")
        d = BUILD / "src" / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        (d / "bucket_kernels.cuh").write_text(src.replace(old, new))
        trees[name] = d
    return trees


def _build(trees: dict[str, Path]) -> dict[tuple[str, str], ctypes.CDLL]:
    """p2g_shard.cu and planes.cu of every tree, one nvcc each, all at once."""
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, d in trees.items():
        for src in ("p2g_shard", "planes"):
            so = BUILD / f"lib{src}-{name}.so"
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(d / f"{src}.cu")]
            jobs.append((name, src, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                         stderr=subprocess.STDOUT, text=True)))
    libs, vp, ci = {}, ctypes.c_void_p, ctypes.c_int
    for name, src, so, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}'s {src}.cu:\n{out}")
        if src == "p2g_shard":
            entry = None
            for line in out.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    entry = m.group(1) if "p2g_mass" in m.group(1) else None
                m = re.search(r"Used (\d+) registers", line)
                if entry and m:
                    vc = "bf16" if "bfloat16" in entry else "f32"
                    gt = "int" if re.search(r"(E13__nv_bfloat16|Ef)iN", entry) else "float"
                    print(f"  {name}: pass 1 ({vc} vel and C, {gt} grid): {m.group(1)} "
                          f"registers", flush=True)
                elif entry and "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(str(so))
        if src == "p2g_shard":
            lib.p2g1_shard.argtypes = [vp, ci] + [vp] * 6 + [ci, ci, vp]
            lib.p2g1_shard.restype = ci
        else:
            lib.p2g1_planes.argtypes = [vp] * 8
            lib.p2g1_planes.restype = ci
        libs[(name, src)] = lib
    return libs


def _compare(label: str, calls: dict, smi: str) -> None:
    """Every call's outputs equal the first's; then the times in turns."""
    outs = {}
    for name, (fn, res) in calls.items():
        fn()
        torch.cuda.synchronize()
        outs[name] = [t.clone() for t in res]
    first = next(iter(outs.values()))
    for name, out in outs.items():
        if not all(torch.equal(x, y) for x, y in zip(out, first)):
            raise AssertionError(f"{label}: {name} differs from {next(iter(outs))}")
    times = {name: [] for name in calls}
    for name in list(calls) + list(reversed(calls)):
        times[name].append(cuda_time_ms(calls[name][0], iters=50))
    for name, (t1, t2) in times.items():
        print(f"{label} {name}: {t1:.4f} / {t2:.4f} ms, bit-equal to {next(iter(outs))} [{smi}]",
              flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[], help="NAME=CSRC_DIR, timed first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pass1_variants needs a CUDA device")
    smi = _smi()
    trees = _trees(args.tree)
    t0 = time.perf_counter()
    libs = _build(trees)
    print(f"built {len(trees)} trees in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    P = build.ptr
    stream = build.stream_of(dev)

    sc, win, _ = config5_windows(dev)
    state = settle(win, win.init(sc.state), sc.fluid)
    cfgw = win.config
    loc, pc = cfgw.grid_res[0] // SLABS, cfgw.num_cells // cfgw.grid_res[0]
    slab = domain._exchange_state_halo(
        domain.shard_bucket_state(state, cfgw, domain.SlabMesh.on(dev, SLABS)).slabs, pc)[1]
    del state
    cfg, x0 = bucketed.slab_config(cfgw, loc + 4), loc - 2
    params = params_for(cfg, sc.fluid)
    gc = pc * (cfg.grid_res[0] + 2)
    calls = {}
    for name in trees:
        gm = torch.empty((gc,), dtype=torch.float32, device=dev)
        gp = torch.empty((3, gc), dtype=torch.float32, device=dev)

        def fn(lib=libs[(name, "p2g_shard")], gm=gm, gp=gp):
            build.check_rc("p2g1_shard", lib.p2g1_shard(
                ctypes.byref(params), x0, P(slab.pos), P(slab.vel), P(slab.C), P(slab.mass),
                P(gm), P(gp), 1, 0, stream))
        calls[name] = (fn, (gm, gp))
    _compare(f"p2g1_shard, config 5 slab 1 of {SLABS} {cfg.grid_res} K={cfg.bin_capacity} "
             f"bf16 ({int((slab.mass > 0).sum())} slots occupied):", calls, smi)
    del slab, calls
    torch.cuda.empty_cache()

    sc3 = fluid_3d(device=dev)
    cfg3 = sc3.config.replace(storage_dtype="float32")
    s3 = bucketed.from_simstate(sc3.state, cfg3)
    for _ in range(3):
        s3 = bucketed.substep(s3, cfg3, sc3.fluid)
    params3 = params_for(cfg3, sc3.fluid)
    calls = {}
    for name in trees:
        gm = torch.empty((cfg3.num_cells,), dtype=torch.float32, device=dev)
        gp = torch.empty((3, cfg3.num_cells), dtype=torch.float32, device=dev)

        def fn(lib=libs[(name, "planes")], gm=gm, gp=gp):
            build.check_rc("p2g1_planes", lib.p2g1_planes(
                ctypes.byref(params3), P(s3.pos), P(s3.vel), P(s3.C), P(s3.mass), P(gm), P(gp),
                stream))
        calls[name] = (fn, (gm, gp))
    _compare(f"A, fluid_3d {cfg3.grid_res} K={cfg3.bin_capacity} f32 after 3 substeps:", calls,
             smi)


if __name__ == "__main__":
    main()
