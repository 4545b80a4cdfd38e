"""The camera and reporting flags of the port's CLI on the CPU
(`main([...])` with fluid_3d_cpu, --device cpu --mode bucketed
--substeps 1), as tests/test_cli.py and tests/test_flycam.py drive the JAX
package's: --orbit-camera, --fly-script with the fly pointer's push, the
HUD, --metrics of `run` and `render`, and --guard."""

import glob
import json

import numpy as np
import torch

from mpm_tpu_torch.__main__ import main
from mpm_tpu_torch.render.image import read_png_rgb
from mpm_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

BASE = ["fluid_3d_cpu", "--device", "cpu", "--mode", "bucketed", "--substeps", "1"]


def events(path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def lost_zero(text: str) -> bool:
    return any(line.startswith("lost: 0 ") for line in text.splitlines())


def test_render_orbit_camera(tmp_path, capsys):
    """--orbit-camera: the first and last frames differ by more than 1 mean
    |du8|; a moving camera takes no crop."""
    out = tmp_path / "orb"
    main(["render", *BASE, "--frames", "3", "--orbit-camera", "--width", "120", "--height", "80",
          "--out", str(out)])
    text = capsys.readouterr().out
    assert "camera=moving" in text and "fluid crop" not in text
    a = read_png_rgb(str(out / "frame_00000.png")).astype(float)
    b = read_png_rgb(str(out / "frame_00002.png")).astype(float)
    assert np.abs(a - b).mean() > 1.0


def _fly_checkpoint_pos(tmp_path, name, script):
    out, ck = tmp_path / name, tmp_path / (name + "_ck")
    main(["render", *BASE, "--frames", "2", "--out", str(out), "--width", "96", "--height", "64",
          "--render-mode", "velocity_spheres", "--fly-script", script, "--fly-plane-y", "16",
          "--fly-sphere-radius", "30", "--fly-sphere-strength", "2.0",
          "--checkpoint-every", "2", "--checkpoint-dir", str(ck)])
    assert len(glob.glob(str(out / "*.png"))) == 2
    state, _, _, _ = checkpoint.load(str(ck / "frame_00002.npz"))
    return state.pos.numpy()


def test_fly_pointer_displaces_fluid(tmp_path):
    """Holding 'p' pushes the fluid with the pointer's sphere: the
    checkpointed positions with and without the push differ."""
    pushed = _fly_checkpoint_pos(tmp_path, "push", "p:2")
    idle = _fly_checkpoint_pos(tmp_path, "idle", ".:2")
    assert pushed.shape == idle.shape
    assert np.abs(pushed - idle).max() > 0.01


def test_fly_script_hud_and_metrics(tmp_path):
    """A scripted flight with the HUD and the render metrics: frames differ
    as the camera moves, the HUD's white glyphs sit in the top-left box,
    and the JSONL holds the JAX package's render events with the
    device/host split."""
    out, met = tmp_path / "fly", tmp_path / "m.jsonl"
    main(["render", *BASE, "--frames", "3", "--width", "160", "--height", "90", "--out", str(out),
          "--fly-script", "w:1,wi:1,l:1", "--fly-speed", "30", "--hud", "--metrics", str(met)])
    pngs = sorted(glob.glob(str(out / "*.png")))
    assert len(pngs) == 3
    first, last = (read_png_rgb(p) for p in (pngs[0], pngs[-1]))
    assert not np.array_equal(first, last)
    assert (last[:60, :150] == 255).all(axis=-1).any()
    ev = events(met)
    assert [e["event"] for e in ev] == ["compile", "frame", "frame", "counters", "summary"]
    assert ev[-2]["lost"] == 0 and ev[1]["dev_ms"] > 0 and "host_ms" in ev[1]
    assert ev[-1]["frames"] == 3


def test_run_metrics_and_guard(tmp_path, capsys):
    """--metrics with --guard, interactions and fluid overrides: the JAX
    package's run events in order, the guard's with no failure."""
    met = tmp_path / "m.jsonl"
    main(["run", *BASE, "--frames", "3", "--guard", "--guard-snapshot-every", "2",
          "--guard-check-every", "1", "--metrics", str(met), "--interact", "sphere=16,6,16,4",
          "--orbit-sphere", "--fluid", "dt=0.15", "--flip-gravity-at", "2"])
    text = capsys.readouterr().out
    assert "interactions=2" in text and lost_zero(text)
    ev = events(met)
    assert [e["event"] for e in ev] == ["compile", "frame", "frame", "frame", "guard",
                                       "counters", "summary"]
    assert ev[4] == {"t": ev[4]["t"], "event": "guard", "failures": 0, "frames_lost": 0,
                     "dt_scale": 1.0}
    assert ev[0]["n"] == 32768 and ev[-1]["frames"] == 3
