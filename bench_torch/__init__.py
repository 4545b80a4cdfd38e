"""The benchmark of mpm_tpu_torch on one NVIDIA H100 (see BENCHMARK.json at
the repository root). One process runs one cell:

    python3 -m bench_torch.run --workload pool_1m.sim --seed 7 --seconds 10 --trace 0

Cells, configurations, traffic drivers and per-layer metrics are files
found by name: workloads/<cell>.json, configs/<config>.json,
drivers/<driver>.py, metrics/<metric>.py."""
