"""The sharded render composite (mpm_tpu_torch/parallel/render.py) on the
CPU, the pattern of tests/test_dist_render.py: per-slab splat emission ->
per-slab z-buffer -> elementwise min -> SSFR.

1. The composite is exact: the min of the z-buffers of disjoint splat
   subsets equals the z-buffer of all of them, bit for bit.
2. The sharded frame equals make_full_frame_step's frame from the same
   state bit for bit: the sharded substeps equal the unsharded ones slot for
   slot (tests/test_torch_sharded.py) and the min composite is exact.
3. `render --shards` through the CLI, and its refusals."""

import os

import pytest
import torch

from mpm_tpu_torch.__main__ import main as cli_main
from mpm_tpu_torch.core.params import FluidParams, SimConfig
from mpm_tpu_torch.core.state import make_state
from mpm_tpu_torch.models.emitters import box_lattice
from mpm_tpu_torch.ops import bucketed as tb
from mpm_tpu_torch.parallel import domain
from mpm_tpu_torch.parallel.render import demo_sharded_render, make_sharded_frame_step
from mpm_tpu_torch.render import (Camera, RenderConfig, background_for_view, domain_crop,
                                  make_full_frame_step)
from mpm_tpu_torch.render.camera import look_at
from mpm_tpu_torch.render.extract_kernel import extract_cell_splats_plain
from mpm_tpu_torch.render.splat import zbuffer_cells

torch.set_num_threads(2)


def _scene(grid=(16, 16, 16)):
    pos = box_lattice(grid, (10.0, 6.0, 10.0), 0.8, center=(8.0, 6.0, 8.0))
    config = SimConfig(grid_res=grid, num_particles=pos.shape[0], substeps=2, bin_capacity=8)
    fluid = FluidParams.create(dim=3, eos_stiffness=4.0, eos_power=4.0)
    return config, fluid, make_state(pos, "cpu")


def _view():
    return torch.from_numpy(look_at((40.0, 30.0, 40.0), (8.0, 6.0, 8.0)))


def test_zbuffer_composite_is_exact():
    config, _, state = _scene()
    b = tb.from_simstate(state, config)
    cam = Camera(width=128, height=96)
    cells = extract_cell_splats_plain(b, _view(), cam)
    full = zbuffer_cells(cells, cam)
    m = cells.shape[1] // 4
    parts = [zbuffer_cells(cells[:, i * m:(i + 1) * m], cam) for i in range(4)]
    merged = parts[0]
    for p in parts[1:]:
        merged = torch.minimum(merged, p)
    assert torch.equal(merged, full)
    assert int((full < 4000.0).sum()) > 100  # fluid on the buffer


@pytest.mark.parametrize("crop", [False, True])
def test_sharded_frame_matches_single_device(crop):
    """One frame (2 substeps + emission + composite + SSFR + u8) on 4 slabs
    against make_full_frame_step from the same state: state slot for slot
    and frame bit for bit, with and without the domain crop."""
    config, fluid, state = _scene()
    view = _view()
    rc = RenderConfig(camera=Camera(width=128, height=96))
    if crop:
        rc = domain_crop(rc, config, view)
        assert rc.crop is not None
    bg = background_for_view(rc, view, "cpu")
    b0 = tb.from_simstate(state, config)
    mesh = domain.SlabMesh.on("cpu", 4)
    out, img = make_sharded_frame_step(config, mesh, rc)(
        domain.shard_bucket_state(b0, config, mesh), fluid, (), view, bg)
    ref, want = make_full_frame_step(config, rc, config.substeps)(b0, fluid, (), view, bg)
    got = domain.gather_bucket_state(out)
    for f in ("pos", "vel", "C", "mass", "ids", "lost", "cfl_clamped", "deferred", "ceiling"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert img.dtype == torch.uint8 and tuple(img.shape) == (96, 128, 3)
    assert torch.equal(img, want)
    assert int((img != bg[0].mul(255).to(torch.uint8)).any(dim=-1).sum()) > 100


def test_sharded_render_refuses_particle_quality():
    config, _, _ = _scene()
    rc = RenderConfig(camera=Camera(width=128, height=96), quality="particle")
    with pytest.raises(ValueError, match="quality 'cell' only"):
        make_sharded_frame_step(config, domain.SlabMesh.on("cpu", 2), rc)


def test_demo_sharded_render_on_cpu():
    demo_sharded_render(2, device="cpu")


def test_cli_render_shards(tmp_path, capsys):
    out = tmp_path / "frames"
    cli_main(["render", "fluid_3d_cpu", "--shards", "2", "--device", "cpu", "--mode",
              "bucketed", "--frames", "2", "--substeps", "1", "--width", "128", "--height", "72",
              "--out", str(out)])
    text = capsys.readouterr().out
    assert "mesh: 2 x-slab shard(s) over cpu devices" in text and "\nlost: 0 " in text
    assert sorted(os.listdir(out)) == ["frame_00000.png", "frame_00001.png"]


@pytest.mark.parametrize("extra, msg", [
    (["--window", "auto"], "supports --window off only"),
    (["--render-quality", "particle"], "requires --render-quality cell"),
])
def test_cli_render_shards_refusals(tmp_path, extra, msg):
    with pytest.raises(SystemExit, match=msg):
        cli_main(["render", "fluid_3d_cpu", "--shards", "2", "--device", "cpu", "--mode",
                  "bucketed", "--frames", "1", "--out", str(tmp_path), *extra])
