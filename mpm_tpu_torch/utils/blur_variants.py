"""Times kernel BL (csrc/blur_depth.cu) beside variants of its source, on one
CUDA card, on the four buffers of utils/profile_render_kernels.blur_buffers
(the settled 1M pool's splat buffers cut to the two render crops, and the
full 640x360 and 1080p frames with a near patch of filter size 100). Every
variant's output must equal the first tree's bit for bit; each is timed
with CUDA events (50 launches) and its device time a launch with the host's
time hidden (profile_render_kernels.device_ms), in turns, first to last,
then last to first. nvcc's
registers of each tree's kernels are printed.

    python -m mpm_tpu_torch.utils.blur_variants [--tree NAME=CSRC_DIR ...]

The trees: any given with --tree (a copy of mpm_tpu_torch/csrc, such as the
parent commit's from `git archive`, whose blur_depth takes (depth, tmp, out,
...) as this one's does), this checkout's csrc ("this"), and the variants of
VARIANTS, each this checkout's blur_depth.cu with one edit. The C entry
points are called directly, so the times leave out the Python wrapper's.
Builds go to mpm_tpu_torch/_build/variants. Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import time
from pathlib import Path

import torch

from ..models.scenes import benchmark_scene
from ..ops.cuda import build
from ..render import default_view
from ..render import blur_kernel as kb
from .profile_render_kernels import BL_ARGS, blur_buffers, device_ms
from .render_bench import N_POOL, pool_window, recipe_360, recipe_1080, settle
from .timing import cuda_time_ms

BUILD = build.BUILD_DIR / "variants"

_SHAPE = "constexpr int TH = 8;                 // a Y tile's rows\n" \
         "constexpr int NWARPS = 8;             // warps a block\n"
# the two launches, replaced whole by one launch for both passes
_KERNELS = ("// The X pass: a block of NWARPS rows", "}  // namespace")
_ONE_LAUNCH = """// The X pass of image row y at the tile's 32 columns, by one warp, into
// dst[0..31]; buf is the warp's row buffer of TW + 2 reach floats.
__device__ __forceinline__ void x_pass_row(const float* __restrict__ in, int y, int x0,
                                           const BlurParams& p, float* buf, float* dst,
                                           int lane) {
  const int x = x0 + lane;
  const float* row = in + (size_t)y * p.w;
  const float d = x < p.w ? row[x] : 0.f;
  const bool lv = x < p.w && live(d);
  float inv_2ss2 = 0.f;
  const int n = lv ? filter_size(d, p, inv_2ss2) : 0;
  const int r = __reduce_max_sync(0xffffffffu, n > 0 ? n : 0);
  float* seg = buf + p.reach - r;
  for (int j = lane; j < TW + 2 * r; j += 32) {
    const int xx = x0 - r + j;
    seg[j] = xx >= 0 && xx < p.w ? row[xx] : BG_DEPTH;
  }
  __syncwarp();
  const float* c = buf + p.reach + lane;
  dst[lane] = lv ? blur_sum(d, n, inv_2ss2, p.inv_2sr2, [&](int k) { return c[k]; }) : d;
  __syncwarp();
}

// Both passes in one launch: the tile's rows' X pass, then its largest Y
// filter size R, then the X pass of the R halo rows above and below into the
// block's column strip, then the Y pass from the strip.
__global__ void __launch_bounds__(NWARPS * 32)
    blur_tile(const float* __restrict__ in, float* __restrict__ out, BlurParams p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int y1 = min(y0 + TH, p.h);
  const int x = x0 + lane;
  float* strip = smem;
  const int sb = p.reach - y0;
  float* buf = smem + (TH + 2 * p.reach) * TW + warp * (TW + 2 * p.reach);
  __shared__ int ry_max;
  if (threadIdx.x == 0) ry_max = 0;
  for (int y = y0 + warp; y < y1; y += NWARPS)
    x_pass_row(in, y, x0, p, buf, strip + (y + sb) * TW, lane);
  __syncthreads();
  int ry = 0;
  for (int y = y0 + warp; y < y1; y += NWARPS) {
    const float d = strip[(y + sb) * TW + lane];
    float inv_2ss2;
    if (x < p.w && live(d)) ry = max(ry, filter_size(d, p, inv_2ss2));
  }
  ry = __reduce_max_sync(0xffffffffu, ry);
  if (lane == 0 && ry > 0) atomicMax(&ry_max, ry);
  __syncthreads();
  const int ys = max(y0 - ry_max, 0), ye = min(y1 + ry_max, p.h);
  const int above = y0 - ys;
  for (int j = warp; j < above + (ye - y1); j += NWARPS) {
    const int y = j < above ? ys + j : y1 + (j - above);
    x_pass_row(in, y, x0, p, buf, strip + (y + sb) * TW, lane);
  }
  __syncthreads();
  if (x >= p.w) return;
  for (int y = y0 + warp; y < y1; y += NWARPS) {
    const float* c = strip + (y + sb) * TW + lane;
    const float d = c[0];
    float o = d;
    if (live(d)) {
      float inv_2ss2;
      const int n = filter_size(d, p, inv_2ss2);
      o = blur_sum(d, n, inv_2ss2, p.inv_2sr2, [&](int k) {
        const int yy = y + k;
        return yy >= 0 && yy < p.h ? c[k * TW] : BG_DEPTH;
      });
    }
    out[(size_t)y * p.w + x] = o;
  }
}

int smem_x(int reach) { return (TW * (TH + 2 * reach) + NWARPS * (TW + 2 * reach)) * 4; }
int smem_y(int reach) { return 0; }

"""
_ENTRY = ("  cudaStream_t s = (cudaStream_t)stream;", "}  // extern \"C\"")
_ONE_LAUNCH_ENTRY = """  cudaFuncSetAttribute(blur_tile,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, sx);
  blur_tile<<<dim3((w + TW - 1) / TW, (h + TH - 1) / TH), NWARPS * 32, sx,
              (cudaStream_t)stream>>>(depth, out, p);
  return (int)cudaGetLastError();
}

"""
_ALLOW = ("  static int set_x[64], set_y[64];", "  if (err != cudaSuccess) return (int)err;\n")

# the Y pass reading its taps from tmp through L1, not from a staged strip
_Y_STAGED = ("  float* col = smem + p.reach * TW + lane;", "int smem_x(int reach)")
_Y_DIRECT = """  (void)R;
  if (x >= p.w) return;
  for (int y = y0 + warp; y < y1; y += NWARPS) {
    const float* g = tmp + (size_t)y * p.w + x;
    out[(size_t)y * p.w + x] = blur_pixel(g[0], p, [&](int k) {
      return y + k >= 0 && y + k < p.h ? g[(long long)k * p.w] : BG_DEPTH;
    });
  }
}

"""

# name: [(text in blur_depth.cu, its replacement) or ((start, end), replacement)]
VARIANTS = {
    # one launch for both passes on tiles of 32 x 32 pixels, the X pass of
    # each tile's R halo rows done again in the tile, nothing written between
    # the passes
    "one_launch": [(_SHAPE, _SHAPE.replace("= 8; ", "= 32;")),
                   (_KERNELS, _ONE_LAUNCH + "}  // namespace"),
                   (_ALLOW, "  cudaError_t err = cudaSuccess;\n"),
                   (_ENTRY, _ONE_LAUNCH_ENTRY)],
    # blocks of 16 and of 4 warps: X blocks of 16 or 4 rows, Y tiles of 16 or
    # 4 x 32 pixels
    "tile16": [(_SHAPE, _SHAPE.replace("= 8; ", "= 16;"))],
    "tile4": [(_SHAPE, _SHAPE.replace("= 8; ", "= 4; "))],
    "y_direct": [(_Y_STAGED, _Y_DIRECT)],
}


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _edit(src: str, name: str, old, new: str) -> str:
    if isinstance(old, tuple):
        a, b = src.find(old[0]), src.find(old[1])
        if a < 0 or b < a:
            raise RuntimeError(f"variant {name}: its markers are not in blur_depth.cu")
        return src[:a] + new + src[b:]
    if old not in src:
        raise RuntimeError(f"variant {name}: its text is not in blur_depth.cu")
    return src.replace(old, new)


def _sources(extra: list[str]) -> dict[str, Path]:
    """name -> blur_depth.cu of each tree (the variants written under BUILD)."""
    srcs = {}
    for spec in extra:
        name, _, path = spec.partition("=")
        srcs[name] = Path(path).resolve() / "blur_depth.cu"
    srcs["this"] = build.CSRC / "blur_depth.cu"
    base = srcs["this"].read_text()
    for name, edits in VARIANTS.items():
        src = base
        for old, new in edits:
            src = _edit(src, name, old, new)
        d = BUILD / "src" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "blur_depth.cu").write_text(src)
        srcs[name] = d / "blur_depth.cu"
    return srcs


def _build(srcs: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """name -> library; one nvcc each, all at once."""
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, src in srcs.items():
        so = BUILD / f"libblur_depth-{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(so), str(src)]
        jobs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    libs = {}
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, so, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}'s blur_depth.cu:\n{out}")
        regs = re.findall(r"Used (\d+) registers", out)
        print(f"  {name}: registers {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.blur_depth.argtypes = [vp] * 3 + [ci] * 4 + [cf, cf, vp]
        lib.blur_depth.restype = ci
        libs[name] = lib
    return libs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[], help="NAME=CSRC_DIR, timed first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("blur_variants needs a CUDA device")
    smi = _smi()
    srcs = _sources(args.tree)
    t0 = time.perf_counter()
    libs = _build(srcs)
    print(f"built {len(srcs)} trees in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    stream = build.stream_of(dev)

    pool = benchmark_scene(N_POOL, device=dev)
    win = pool_window(pool)
    state = settle(win, win.init(pool.state), pool.fluid)
    view = default_view(pool.config.grid_res)
    crops = (recipe_360(pool.config, view).crop,
             recipe_1080(pool.config, state, win.config.grid_res, view).crop)
    bufs = blur_buffers(state, view, *crops)
    del state
    totals = {name: [0.0, 0.0] for name in libs}
    for key, (d, cam) in bufs.items():
        h, w = d.shape
        pc = ctypes.c_float(kb.proj_const_for(cam, BL_ARGS["blur_filter_size"]))
        inv = ctypes.c_float(kb._inv_2sr2(BL_ARGS["depth_threshold"]))
        r = BL_ARGS["radius"]
        calls, outs = {}, {}
        for name, lib in libs.items():
            # the scratch: the X pass, and in this tree each tile's R after it
            words = (lib.blur_depth_scratch_words(h, w) if hasattr(lib, "blur_depth_scratch_words")
                     else h * w)
            out = torch.empty_like(d)
            scratch = torch.empty(words, dtype=torch.float32, device=d.device)
            ptrs = [d.data_ptr(), scratch.data_ptr(), out.data_ptr()]

            def fn(lib=lib, ptrs=ptrs):
                build.check_rc("blur_depth", lib.blur_depth(*ptrs, h, w, r, r, pc, inv, stream))
            fn()
            torch.cuda.synchronize()
            calls[name], outs[name] = fn, out
        first = next(iter(outs))
        for name, out in outs.items():
            if not torch.equal(out, outs[first]):
                raise AssertionError(f"{key}: {name} differs from {first}")
        times = {name: [] for name in calls}
        for name in list(calls) + list(reversed(calls)):
            times[name].append((cuda_time_ms(calls[name], iters=50), device_ms(calls[name])))
        for name, ((e1, d1), (e2, d2)) in times.items():
            totals[name][0] += (e1 + e2) / 2
            totals[name][1] += (d1 + d2) / 2
            print(f"{key} {tuple(d.shape)} {name}: event {e1:.4f} / {e2:.4f} ms, device "
                  f"{d1:.4f} / {d2:.4f} ms, bit-equal to {first} [{smi}]", flush=True)
    for name, (e, dv) in totals.items():
        print(f"sum over the four buffers, {name}: event {e:.4f} ms, device {dv:.4f} ms "
              f"[{smi}]", flush=True)


if __name__ == "__main__":
    main()
