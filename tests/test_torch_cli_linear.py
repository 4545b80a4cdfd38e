"""`run` and `render` in modes reference and binned, which step a linear
SimState (mpm_tpu/__main__.py:195-309), through the port's CLI on the CPU:
the state equals make_step's, the frames draw it as a particle array, the
checkpoints convert linear <-> bucket on resume as the JAX package's
resume does, and --guard and --metrics work in these modes.

Bars: bit for bit against make_step on the same scene; frames against the
`--render-mode none` background (more than 20 levels apart somewhere) and
the 2D frame against bucket_frame_2d of the reference state, exactly.
"""

import json

import numpy as np
import pytest
import torch

from mpm_tpu_torch.__main__ import main
from mpm_tpu_torch.models.scenes import get_scene
from mpm_tpu_torch.ops import bucketed
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.render import bucket_frame_2d, frame_to_u8
from mpm_tpu_torch.render.image import read_png_rgb
from mpm_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

BASE3 = ["fluid_3d_fixed_point", "--device", "cpu", "--substeps", "1", "--frames", "2"]


@pytest.mark.parametrize("mode", ["reference", "binned"])
def test_run_linear_modes(mode, tmp_path, capsys):
    """Two frames of one substep: the checkpoint holds make_step's state
    bit for bit; the metrics log compile, frame, guard and summary events
    (no bucket counters); the guard reports nothing."""
    ck = tmp_path / "ck"
    m = tmp_path / "m.jsonl"
    main(["run", *BASE3, "--mode", mode, "--guard", "--guard-check-every", "1",
          "--metrics", str(m), "--checkpoint-every", "2", "--checkpoint-dir", str(ck)])
    out = capsys.readouterr().out
    assert "particles: 4096 finite: True" in out and f"mode={mode}" in out
    state, _, cfg, _ = checkpoint.load(str(ck / "frame_00002.npz"))
    sc = get_scene("fluid_3d_fixed_point", device="cpu")
    step = make_step(sc.config, mode=mode, substeps=1)
    want = sc.state
    for _ in range(3):  # the first frame, then --frames 2
        want = step(want, sc.fluid)
    for f in ("pos", "vel", "C", "mass", "ids"):
        assert torch.equal(getattr(state, f), getattr(want, f)), f
    events = [json.loads(line)["event"] for line in m.read_text().splitlines()]
    assert {"compile", "frame", "guard", "summary"} <= set(events) and "counters" not in events


def test_resume_converts_between_linear_and_buckets(tmp_path, capsys):
    """A binned checkpoint resumes under --mode bucketed (linear -> buckets)
    and a bucketed one under --mode reference (buckets -> linear)."""
    lin, buck = tmp_path / "lin", tmp_path / "buck"
    main(["run", *BASE3, "--mode", "binned", "--checkpoint-every", "1",
          "--checkpoint-dir", str(lin)])
    main(["run", *BASE3, "--mode", "bucketed", "--checkpoint-every", "1",
          "--checkpoint-dir", str(buck)])
    capsys.readouterr()
    main(["run", *BASE3, "--mode", "bucketed", "--resume", str(lin / "frame_00001.npz")])
    out = capsys.readouterr().out
    assert "converted linear checkpoint state to buckets" in out and "lost: 0 " in out
    main(["run", *BASE3, "--mode", "reference", "--resume", str(buck / "frame_00001.npz")])
    out = capsys.readouterr().out
    assert "converted bucket checkpoint state to linear" in out
    assert "particles: 4096 finite: True" in out


def test_render_binned_3d_draws_the_particles(tmp_path):
    """render --mode binned: the particle-array path, a frame unlike the
    background."""
    def frame(name, *extra):
        main(["render", *BASE3[:-2], "--frames", "1", "--width", "96", "--height", "64",
              "--out", str(tmp_path / name), *extra])
        return read_png_rgb(str(tmp_path / name / "frame_00000.png")).astype(int)

    img = frame("b", "--mode", "binned")
    bg = frame("n", "--mode", "binned", "--render-mode", "none")
    assert np.abs(img - bg).max() > 20


def test_render_reference_2d_frame(tmp_path):
    """render dam_break_2d --mode reference: the frame of the oracle's
    state after one frame (bucket_frame_2d draws a linear state too)."""
    main(["render", "dam_break_2d", "--device", "cpu", "--mode", "reference", "--frames", "1",
          "--out", str(tmp_path)])
    sc = get_scene("dam_break_2d", device="cpu")
    step = make_step(sc.config, mode="reference")
    state = step(sc.state, sc.fluid)
    want = frame_to_u8(bucket_frame_2d(state, sc.config.grid_res)).numpy()
    np.testing.assert_array_equal(read_png_rgb(str(tmp_path / "frame_00000.png")), want)
    b = bucketed.from_simstate(state, sc.config)
    assert torch.equal(bucket_frame_2d(b, sc.config.grid_res),
                       bucket_frame_2d(state, sc.config.grid_res))
