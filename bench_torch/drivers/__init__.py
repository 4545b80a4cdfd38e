"""Traffic drivers, one module a kind, found by the name a workload gives."""
