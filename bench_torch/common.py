"""What every driver shares: the files found by name, the scene made from
--seed, the device's clock, and the sampled answers the reference checks."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import random
import time
from pathlib import Path

import torch

from .trace import SAMPLE

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(kind: str, name: str) -> dict:
    """configs/<name>.json or workloads/<name>.json."""
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """drivers/<name>.py or metrics/<name>.py, by path (metric names hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"bench_torch.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), or since this
    module was imported where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def segments(device) -> int:
    """Device memory segments the caching allocator has made so far."""
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(device).get("segment.all.allocated", 0))


def make_scene(cfg: dict, seed: int, device):
    """The program's scene of `cfg` on `device`, its SimConfig and
    FluidParams checked against the file's numbers, its positions moved by
    the seeded jitter (drawn on the device)."""
    from mpm_tpu_torch.models import scenes

    sc = getattr(scenes, cfg["scene"]["fn"])(device=device, **cfg["scene"]["args"])
    check_config(sc.config, sc.fluid, cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2**63))
    j = float(cfg["jitter"])
    st = sc.state
    noise = torch.rand(st.pos.shape, generator=gen, device=st.pos.device, dtype=torch.float32)
    st.pos = (st.pos + (noise * (2.0 * j) - j)).contiguous()
    return sc


def check_config(config, fluid, cfg: dict) -> None:
    """Raise unless the program's scene is the configuration the file states."""
    bad = []
    for key, want in cfg["sim"].items():
        got = getattr(config, key)
        got = list(got) if isinstance(got, tuple) else got
        if got != want:
            bad.append(f"sim.{key}: file {want!r}, program {got!r}")
    for key, want in cfg["fluid"].items():
        got = getattr(fluid, key).tolist()
        if not _close(got, want):
            bad.append(f"fluid.{key}: file {want!r}, program {got!r}")
    if bad:
        raise ValueError("the program's scene is not the configuration file's: " + "; ".join(bad))


def _close(a, b) -> bool:
    if isinstance(a, list):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return abs(a - b) <= 1e-6 * max(1.0, abs(b))


class Reservoir:
    """A uniform sample, drawn from the seed, of `size` of the calls offered
    one by one (their number unknown in advance). A kept call's tensors are
    copied into buffers made at set-up (`prime`), so keeping one inside the
    window allocates nothing and holds none of the program's memory."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.slots: list = [None] * size
        self.seen = 0
        self.rng = random.Random(seed * 1_000_003 + 17)

    def prime(self, *like: torch.Tensor) -> None:
        self.slots = [tuple(torch.empty_like(t) for t in like) for _ in range(self.size)]
        self.kept = 0

    def offer(self, *tensors: torch.Tensor) -> None:
        self.seen += 1
        if self.seen <= self.size:
            j = self.seen - 1
        else:
            j = self.rng.randrange(self.seen)
            if j >= self.size:
                return
        bufs = []
        with torch.profiler.record_function(SAMPLE):  # the trace leaves these copies out
            for b, t in zip(self.slots[j], tensors):
                if b.shape != t.shape or b.dtype != t.dtype:  # a window resize: rare
                    b = torch.empty_like(t)
                bufs.append(b.copy_(t))
        self.slots[j] = tuple(bufs)

    @property
    def items(self) -> list:
        return self.slots[:min(self.seen, self.size)]


@dataclasses.dataclass
class Check:
    """One compared number beside its limit (value <= limit passes)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit
