"""The port's HUD (mpm_tpu_torch/render/hud.py) and FrameStats split
(mpm_tpu_torch/utils/timing.py) against the JAX package's: the same frame
times and device/host splits give the same stats, and burn_in_hud draws
the same bytes into the same u8 and float frames."""

import numpy as np
import pytest

from mpm_tpu.render.hud import burn_in_hud as j_hud
from mpm_tpu.utils.timing import FrameStats as JStats
from mpm_tpu_torch.render.hud import burn_in_hud as t_hud
from mpm_tpu_torch.utils.timing import FrameStats as TStats


def stats_pair(n: int, splits: bool, seed: int = 0):
    """Both packages' FrameStats fed the same n frame times and, with
    `splits`, the same device/host split of each."""
    rng = np.random.default_rng(seed)
    times = rng.uniform(0.004, 0.040, n)
    dev, host = rng.uniform(0.002, 0.03, n), rng.uniform(0.0, 0.005, n)
    out = []
    for cls in (JStats, TStats):
        s = cls(window=150)
        s.times.extend(float(t) for t in times)
        if splits:
            for d, h in zip(dev, host):
                s.split(float(d), float(h))
        out.append(s)
    return out


@pytest.mark.parametrize("n, splits", [(0, False), (1, True), (40, False), (200, True)])
def test_frame_stats_match_jax(n, splits):
    j, t = stats_pair(n, splits)
    assert t.stats == j.stats
    assert len(t.times) == min(n, 150) and len(t.dev_times) == (min(n, 150) if splits else 0)
    if splits and n:
        assert t.stats["dev_ms"] > 0 and t.stats["host_ms"] > 0


def test_frame_stats_tick():
    s = TStats(window=3)
    for _ in range(6):
        s.tick()
    assert len(s.times) == 3 and s.stats["fps"] > 0
    assert s.stats["dev_ms"] == 0.0 and s.stats["host_ms"] == 0.0


@pytest.mark.parametrize("kind, shape, n, splits, extra", [
    ("u8", (360, 640, 3), 60, True, "N=1000000"),
    ("u8", (90, 160, 3), 3, False, ""),
    ("u8", (40, 50, 3), 30, True, "N=32768"),  # smaller than the box
    ("float", (144, 256, 3), 20, True, "N=4096"),
    ("u8-readonly", (120, 200, 3), 12, True, ""),
])
def test_burn_in_hud_matches_jax(kind, shape, n, splits, extra):
    rng = np.random.default_rng(7)
    if kind == "float":
        frame = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    else:
        frame = rng.integers(0, 256, shape, dtype=np.uint8)
    js, ts = stats_pair(n, splits, seed=n)
    fj, ft = frame.copy(), frame.copy()
    if kind == "u8-readonly":  # a frame that arrived read-only is copied
        fj.flags.writeable = ft.flags.writeable = False
    want = j_hud(fj, js, extra=extra)
    got = t_hud(ft, ts, extra=extra)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert not np.array_equal(got, frame)
    if kind == "u8-readonly":
        np.testing.assert_array_equal(ft, frame)
    elif kind.startswith("u8"):
        assert (got[:40, :120] == 255).all(axis=-1).any()  # white glyph pixels
