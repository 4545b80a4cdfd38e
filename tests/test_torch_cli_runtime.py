"""The checkpoint flags of the port's CLI on the CPU (`main([...])` with
fluid_3d_cpu, --device cpu --mode bucketed --substeps 1), as
tests/test_cli.py drives the JAX package's: --checkpoint-every and
--resume, windowed and sharded, and the CLI's refusals of run-time flags.
tests/test_torch_cli_cameras.py has the cameras, the HUD, --metrics and
--guard."""

import glob
import os

import pytest
import torch

from mpm_tpu_torch.__main__ import main
from mpm_tpu_torch.models.scenes import get_scene
from mpm_tpu_torch.ops import bucketed
from mpm_tpu_torch.ops.window import window_config
from mpm_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

BASE = ["fluid_3d_cpu", "--device", "cpu", "--mode", "bucketed", "--substeps", "1"]


def lost_zero(text: str) -> bool:
    return any(line.startswith("lost: 0 ") for line in text.splitlines())


def test_window_checkpoint_resume(tmp_path, capsys):
    """--window auto with --checkpoint-every 1, then --resume with and
    without --window auto. The scene's window fills its grid, so a
    checkpoint of a window under the domain's height (arrays of 28 planes,
    domain_res the true grid) is resumed both ways too: un-windowed
    through a SimState, then re-windowed or put back in buckets."""
    ck = tmp_path / "ck"
    main(["run", *BASE, "--frames", "1", "--window", "auto", "--checkpoint-every", "1",
          "--checkpoint-dir", str(ck)])
    cks = sorted(glob.glob(str(ck / "*.npz")))
    assert [os.path.basename(c) for c in cks] == ["frame_00001.npz"]
    sc = get_scene("fluid_3d_cpu", device="cpu")
    wcfg = window_config(sc.config, 28)
    w28 = str(tmp_path / "window28.npz")
    checkpoint.save(w28, bucketed.from_simstate(sc.state, wcfg), sc.fluid, wcfg)
    assert checkpoint.load(w28)[2]["domain_res"] == [32, 32, 32]
    capsys.readouterr()
    for path, frames in ((cks[-1], "1"), (w28, "0")):
        for window in (["--window", "auto"], []):
            main(["run", *BASE, "--frames", frames, "--resume", path, *window])
            text = capsys.readouterr().out
            assert f"resumed from {path}" in text and lost_zero(text)
            assert ("air-window engine" in text) == bool(window)


def test_resume_refuses_another_domain(tmp_path):
    ck = tmp_path / "ck"
    main(["run", "dam_break_2d", "--device", "cpu", "--mode", "bucketed", "--substeps", "1",
          "--frames", "1", "--checkpoint-every", "1", "--checkpoint-dir", str(ck)])
    with pytest.raises(SystemExit, match="checkpoint domain"):
        main(["run", *BASE, "--frames", "1", "--resume", str(ck / "frame_00001.npz")])


def test_sharded_checkpoint_resume(tmp_path, capsys):
    """--shards 2: the checkpoint holds the gathered state, and a resume
    re-shards it."""
    ck = tmp_path / "ck"
    main(["run", *BASE, "--frames", "1", "--shards", "2", "--checkpoint-every", "1",
          "--checkpoint-dir", str(ck)])
    state, _, cfg, _ = checkpoint.load(str(ck / "frame_00001.npz"))
    assert type(state).__name__ == "BucketState" and state.mass.shape[-1] == 32 ** 3
    assert int((state.mass > 0).sum()) == 32768
    capsys.readouterr()
    main(["run", *BASE, "--frames", "1", "--shards", "2", "--resume",
          str(ck / "frame_00001.npz")])
    text = capsys.readouterr().out
    assert "mesh: 2 x-slab shard(s) over cpu devices" in text and lost_zero(text)


@pytest.mark.parametrize("argv, msg", [
    (["--mode", "reference", "--shards", "2"], "--shards requires a 3D scene on the bucket"),
    (["--mode", "binned", "--shards", "2"], "--shards requires a 3D scene on the bucket"),
    (["--fluid", "gravity=1"], "gravity takes 3 value"),
    (["--interact", "cube=1,2,3,4"], "bad --interact"),
])
def test_cli_refusals(argv, msg):
    with pytest.raises(SystemExit, match=msg):
        main(["run", *BASE, "--frames", "1", *argv])
