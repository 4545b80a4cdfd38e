"""Registers, spills and occupancy of the bucket kernels on one CUDA card:
what `nvcc -Xptxas -v` reports for each instantiation of the two P2G
passes' tile kernels and the migration's kernels (csrc/bucket_kernels.cuh),
and the blocks of each tile kernel that fit on one SM
(cudaOccupancyMaxActiveBlocksPerMultiprocessor).

    python -m mpm_tpu_torch.utils.kernel_resources

Builds the kernels from the sources (ops/cuda/build.py) if needed. Needs a
card for the occupancy; the ptxas lines come from the build.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess

import torch

from ..ops.cuda import build

SOURCES = ("p2g_update", "g2p_migrate", "p2g_shard", "planes", "substep2d")
KERNELS = ("p2g_mass_tile", "p2g_force_tile", "migrate_reject", "migrate_select", "migrate_gather", "g2p_tail")


def _demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt")
    if not tool:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout
    return out.splitlines() if out else names


def ptxas_table(log: str) -> list[tuple[str, int, int, int]]:
    """(entry, registers, spill store bytes, spill load bytes) for each
    entry function of KERNELS in one nvcc -Xptxas -v log."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in KERNELS) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spill))
            name, spill = None, (0, 0)
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_resources needs a CUDA device")
    build.build_all(SOURCES)
    for src in SOURCES:
        rows = ptxas_table(build.build_logs.get(src, ""))
        if not rows:
            print(f"== {src}: built before this process; no ptxas log")
            continue
        print(f"== {src}")
        for (name, regs, st, ld), pretty in zip(rows, _demangle([r[0] for r in rows])):
            print(f"  {regs:4d} registers, spill stores {st} B, loads {ld} B  {pretty[:150]}")
    lib = build.load("p2g_update")
    torch.cuda.init()
    for entry, smem in (("p2g_mass_tile", "110.6 KB"), ("p2g_force_tile", "95.0 KB")):
        fn = getattr(lib, f"{entry}_blocks_per_sm")
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
        for bf16 in (1, 0):
            n = fn(bf16)
            print(f"{entry} (D=3, {'bf16' if bf16 else 'f32'} vel and C, float grid, {smem} of "
                  f"shared memory a block): {n} blocks of 256 threads an SM ({n * 8} of 64 "
                  f"warps) [{torch.cuda.get_device_name(0)}]")


if __name__ == "__main__":
    main()
