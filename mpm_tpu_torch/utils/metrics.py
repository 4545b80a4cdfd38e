"""Structured metrics logging (port of ``mpm_tpu.utils.metrics``).

A JSONL stream, one record a line with the seconds since the logger opened
(`t`) and the `event` name. The CLI loops write the JAX package's events
and fields, so a log pipeline reads both packages' files alike:

- `compile`: the first frame (seconds, scene, mode, n). On the card that
  frame also builds the CUDA kernels on first use, so it holds the build
  where the JAX package's holds its XLA compile;
- `frame`: one a frame after the first (i, last_ms, and avg_ms in `run`,
  dev_ms and host_ms in `render`);
- `guard` (`run --guard`): failures, frames_lost, dt_scale;
- `counters`: lost, deferred, cfl_clamped, ceiling;
- `summary`: frames and the run's rates.
"""

from __future__ import annotations

import json
import time
from typing import IO


class MetricsLogger:
    """Appends records to `path`, or writes them to `stream`; with neither,
    `log` does nothing."""

    def __init__(self, path: str | None = None, stream: IO | None = None):
        self._f = open(path, "a") if path else stream
        self._t0 = time.time()

    def log(self, event: str, **fields):
        if self._f is None:
            return
        rec = {"t": round(time.time() - self._t0, 6), "event": event, **fields}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
