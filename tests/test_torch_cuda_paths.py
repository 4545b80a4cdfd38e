"""The port's main paths on a CUDA card, where tests/test_torch_cuda.py
holds each kernel alone on small scenes: each kernel once beside its plain
version at the scenes its main paths give it (fluid_3d at 64^3, float and
int32 grids; S4; the 1M pool's window; the 2D benchmark; the dense scenes
at K = 72 and 128); whole frames of make_full_frame_step in every render
mode, bit for bit the same frame with every kernel swapped for its plain
version (the `plain_chain` fixture), with each kernel's exact launches a
frame; particle quality with surface bands, the particle-array renderer
with a PNG cubemap and the orbit camera against the plain chain; the slab
exchange's kernel HF against its plain version; on slabs of one card, the
sharded demos, the sharded frames and the sharded air window against their
unsharded runs (the window and HF on distinct cards too, where the host
has two or more); the guard's rollback; the CLI's
spheres on the 1M pool's air window; the 2D frame; the binned engine over
100 substeps; the CLI in this process; the native PNG of a card frame.

The frame tests take the flagship fluid_3d and the benchmark pool, each cut
to a 32^3 grid, at 320x180 under a view closer than default_view: the
smallest that keep fluid on more than 1% of a frame. Every test needs the
card and skips without one. They import no JAX, so on a machine without
JAX run the card's tests with

    python -m pytest --noconftest tests/test_torch_cuda.py tests/test_torch_cuda_paths.py
"""

import contextlib
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from mpm_tpu_torch import native
from mpm_tpu_torch.__main__ import (kernel_launches, live_particles, main as cli_main,
                                    reset_kernel_launches)
from mpm_tpu_torch.models.scenes import (benchmark_dam_break, benchmark_scene,
                                         benchmark_scene_2d, dam_break_2d, fluid_3d,
                                         fluid_3d_fixed_point)
from mpm_tpu_torch.ops import bucketed
from mpm_tpu_torch.ops.cuda import g2p_migrate as kf
from mpm_tpu_torch.ops.cuda import halo_fill
from mpm_tpu_torch.ops.cuda import migrate_planes as ke
from mpm_tpu_torch.ops.cuda import p2g_update as kp
from mpm_tpu_torch.ops.cuda import planes
from mpm_tpu_torch.ops.cuda import step as cuda_step
from mpm_tpu_torch.ops.cuda import substep2d as k2d
from mpm_tpu_torch.ops.cuda.extract_cells import cell_splats_plain
from mpm_tpu_torch.ops.interact import Interaction
from mpm_tpu_torch.ops.step import make_step
from mpm_tpu_torch.ops.window import YWindow
from mpm_tpu_torch.parallel import domain
from mpm_tpu_torch.parallel.render import demo_sharded_render, make_sharded_frame_step
from mpm_tpu_torch.render import (Camera, RenderConfig, SSFRParams, background_for_view,
                                  bucket_frame_2d, default_view, domain_crop, frame_to_u8,
                                  load_cubemap, look_at, make_full_frame_step, render_2d,
                                  render_frame, write_png)
from mpm_tpu_torch.render import blur_kernel as kb
from mpm_tpu_torch.render import extract_kernel as kx
from mpm_tpu_torch.render import pipeline as rpipeline
from mpm_tpu_torch.render import shade_kernel as ksh
from mpm_tpu_torch.render import splat as rsplat
from mpm_tpu_torch.render import ssfr as rssfr
from mpm_tpu_torch.render.flycam import SpherePointer
from mpm_tpu_torch.render.image import read_png_rgb
from mpm_tpu_torch.render.splat import fit_surface_bands, surface_band_uncovered
from mpm_tpu_torch.utils.guard import GuardedStep, state_is_finite
from mpm_tpu_torch.utils.profile_shard import check_settled, config5_windows, settle
from torch_card_cases import (assert_splats_equal, assert_states_close,  # noqa: F401 (dev)
                              assert_states_equal, dev)
from torch_wide_cases import dense_scene

pytestmark = pytest.mark.requires_cuda

CAM = Camera(width=320, height=180)
SLABS = 4
# render modes: (RenderConfig.mode, SSFRParams fields)
MODES = {"default": ("default", {}), "thickness": ("default", {"thickness_pass": True}),
         "velocity_spheres": ("velocity_spheres", {}), "lit_spheres": ("lit_spheres", {}),
         "depth_debug": ("depth_debug", {})}


@pytest.fixture(scope="module")
def flagship(dev):
    """(scene, state, view): fluid_3d on a 32^3 grid (a 16^3 box at spacing
    0.6, 19,683 particles; K=16, f32, 2 substeps a frame) after 10 kernel
    substeps of its fall, and a view of it from 46 cells away."""
    sc = fluid_3d(grid_res=32, box=16.0, device=dev)
    state = make_step(sc.config, mode="cuda", substeps=10)(
        bucketed.from_simstate(sc.state, sc.config), sc.fluid)
    return sc, state, torch.from_numpy(look_at((44.0, 34.0, 44.0), (16.0, 10.0, 16.0)))


def _pool(dev, chunks: int = 5):
    """(scene, window, state, view): the benchmark pool on a 32^3 grid
    (40,000 particles, K=8, bf16 vel/C) under its air window (chunks of 10
    substeps, headroom 4) after `chunks` chunks. A window of its own for
    each test: stepping it may resize it."""
    sc = benchmark_scene(40_000, grid_res=(32, 32, 32), device=dev)
    win = YWindow(sc.config, mode="cuda", substeps=10, headroom=4)
    state = win.init(sc.state)
    for _ in range(chunks):
        state = win.step(state, sc.fluid)
    return sc, win, state, torch.from_numpy(look_at((46.0, 30.0, 46.0), (16.0, 6.0, 16.0)))


@pytest.fixture
def plain_chain(monkeypatch):
    """A context manager under which the frame chain runs every kernel's
    plain version on the card: the substeps through P's and F's, the
    emission through the per-cell plain code, the z-buffer, key and
    dilations through the plain splat pass, the blur through BL's, the
    shade through SH's."""
    def substep(state, config, fp, inter=()):
        grid = kp.p2g_update_plain(state, config, fp)
        return kf.g2p_migrate_plain(state, grid, config, fp, inter)

    def substep_emit(state, config, fp, inter, rs):
        out = substep(state, config, fp, inter)
        return out, cell_splats_plain(out.pos, out.vel, out.mass, rs)

    def dilate(depth, cam, sphere_radius, max_radius_px, velocity=None, with_velocity=False,
               with_normals=False):  # splat_particles' dilation of its deposit
        return rsplat._dilate_spheres(rsplat.SplatBuffers(depth=depth, velocity=velocity), cam,
                                      sphere_radius, max_radius_px, with_velocity=with_velocity,
                                      with_normals=with_normals)

    @contextlib.contextmanager
    def chain():
        with monkeypatch.context() as m:
            m.setattr(cuda_step, "substep", substep)
            m.setattr(cuda_step, "substep_emit", substep_emit)
            m.setattr(rsplat, "zbuffer_cells", rsplat.zbuffer_cells_plain)
            m.setattr(rsplat, "velocity_key", rsplat.velocity_key_plain)
            m.setattr(rsplat, "buffers_from_zbuffer", rsplat.buffers_from_zbuffer_plain)
            m.setattr(rsplat, "_dilate_kernel", dilate)
            m.setattr(rssfr, "blur_depth_kernel", kb.blur_depth_plain)
            m.setattr(rpipeline, "shade_kernel", ksh.shade_plain)
            reset_kernel_launches()
            yield
            assert not any(kernel_launches().values()), kernel_launches()

    return chain


def due_launches(mode: str, substeps: int) -> dict:
    """Each kernel's launches in a frame of make_full_frame_step at cell
    quality (render/pipeline.py): P and F each substep, F's emission
    on the last; a z-buffer, and a velocity key in the sphere modes
    (_needs_velocity); one dilation; BL but in the sphere modes; SH in the
    default mode alone. A frame at particle quality launches the same."""
    spheres = mode in ("velocity_spheres", "lit_spheres")
    due = {"p2g_update": substeps, "g2p_migrate": substeps, "g2p_migrate_emit": 1,
           "splat_zbuffer": 2 if spheres else 1, "splat_dilate": 1,
           "blur_depth": 0 if spheres else 1, "ssfr_shade": int(mode == "default")}
    return {k: due.get(k, 0) for k in kernel_launches()}


def _launched(fn):
    """fn()'s result and the launches it made, the card drained around it."""
    torch.cuda.synchronize()
    reset_kernel_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, kernel_launches()


def _rc(mode: str, config, view, **ssfr) -> RenderConfig:
    return domain_crop(RenderConfig(camera=CAM, mode=mode, ssfr=SSFRParams(**ssfr)), config,
                       view)


def _fluid_share(img, bg, rc) -> float:
    """Share of the crop's (or the frame's) pixels more than 2 u8 levels
    from the background in some channel; the depth view draws the
    background white."""
    if rc.mode == "depth_debug":
        return float((img < 255).any(dim=-1).float().mean())
    y0, x0, ch, cw = rc.crop or (0, 0, rc.camera.height, rc.camera.width)
    d = (img.int() - frame_to_u8(bg[0]).int()).abs().amax(dim=-1)
    return float((d[y0:y0 + ch, x0:x0 + cw] > 2).float().mean())


@pytest.mark.parametrize("case", list(MODES))
def test_frame_equals_the_plain_chain(dev, flagship, plain_chain, case):
    """A frame of each render mode on the card equals the plain chain's bit
    for bit, and a second call's; the stepped states are equal; each
    kernel launches its due count; the thickness frame differs from the
    constant-thickness one."""
    sc, state, view = flagship
    mode, ssfr = MODES[case]
    rc = _rc(mode, sc.config, view, **ssfr)
    bg = background_for_view(rc, view, dev)
    frame = make_full_frame_step(sc.config, rc, sc.config.substeps)
    (s1, img), launched = _launched(lambda: frame(state, sc.fluid, (), view, bg))
    assert launched == due_launches(mode, sc.config.substeps)
    _, again = frame(state, sc.fluid, (), view, bg)
    with plain_chain():
        s2, plain = frame(state, sc.fluid, (), view, bg)
    assert torch.equal(img, plain), int((img != plain).any(dim=-1).sum())
    assert torch.equal(img, again)
    assert_states_equal(s1, s2)
    assert int(s1.lost) == int(state.lost)
    assert _fluid_share(img, bg, rc) >= 0.01
    if ssfr:
        const = make_full_frame_step(sc.config, _rc(mode, sc.config, view), sc.config.substeps)
        assert not torch.equal(img, const(state, sc.fluid, (), view, bg)[1])


@pytest.mark.parametrize("thickness", [False, True])
def test_particle_quality_frame_equals_the_plain_chain(dev, plain_chain, thickness):
    """Particle quality with surface bands fitted on the pool (R 8), on its
    frozen window: bit for bit the plain chain, the due launches, and the
    band certificate 0 on the stepped state."""
    sc, win, state, view = _pool(dev)
    cfg = win.config
    bands = fit_surface_bands(state, cfg.grid_res)
    assert bands is not None
    rc = domain_crop(RenderConfig(camera=CAM, quality="particle", max_radius_px=8,
                                  ssfr=SSFRParams(thickness_pass=thickness),
                                  surface_bands=bands), sc.config, view)
    bg = background_for_view(rc, view, dev)
    frame = make_full_frame_step(cfg, rc, sc.config.substeps)
    (s1, img), launched = _launched(lambda: frame(state, sc.fluid, (), view, bg))
    assert launched == due_launches("default", sc.config.substeps)
    with plain_chain():
        s2, plain = frame(state, sc.fluid, (), view, bg)
    assert torch.equal(img, plain), int((img != plain).any(dim=-1).sum())
    assert_states_equal(s1, s2)
    assert surface_band_uncovered(s1, cfg.grid_res, bands) == 0
    assert int(s1.lost) == int(state.lost) and int(s1.ceiling) == 0
    assert _fluid_share(img, bg, rc) >= 0.01


# frames of the benchmark's render cells at their own size: (width, height,
# SSFRParams fields) of bench_torch/workloads/<cell>.json on fluid_3d at 64^3
CELL_FRAMES = {"flagship_thickness_1080": (1920, 1080, {"thickness_pass": True,
                                                        "thickness_scale": 0.35,
                                                        "thickness_blur_radius": 6})}


@pytest.mark.parametrize("case", list(CELL_FRAMES))
def test_cell_frame_equals_the_plain_chain(dev, plain_chain, case):
    """The reference's scene (fluid_3d at 64^3, 157,464 particles, after 20
    kernel substeps) at a benchmark cell's size under default_view and the
    domain crop: bit for bit the plain chain, the stepped states equal, the
    due launches, and one thickness deposit and one map a frame."""
    sc = fluid_3d(device=dev)
    state = make_step(sc.config, mode="cuda", substeps=20)(
        bucketed.from_simstate(sc.state, sc.config), sc.fluid)
    w, h, ssfr = CELL_FRAMES[case]
    view = default_view(sc.config.grid_res)
    rc = domain_crop(RenderConfig(camera=Camera(width=w, height=h), ssfr=SSFRParams(**ssfr)),
                     sc.config, view)
    assert rc.crop is not None
    bg = background_for_view(rc, view, dev)
    frame = make_full_frame_step(sc.config, rc, sc.config.substeps)
    calls = rsplat.thickness_deposits, rssfr.thickness_maps
    (s1, img), launched = _launched(lambda: frame(state, sc.fluid, (), view, bg))
    assert launched == due_launches("default", sc.config.substeps)
    assert (rsplat.thickness_deposits - calls[0], rssfr.thickness_maps - calls[1]) == (1, 1)
    with plain_chain():
        s2, plain = frame(state, sc.fluid, (), view, bg)
    assert (rsplat.thickness_deposits - calls[0], rssfr.thickness_maps - calls[1]) == (2, 2)
    assert torch.equal(img, plain), int((img != plain).any(dim=-1).sum())
    assert_states_equal(s1, s2)
    assert int(s1.lost) == 0
    assert _fluid_share(img, bg, rc) >= 0.01


def test_thickness_replay_equals_the_eager_pass(dev, flagship):
    """make_full_frame_step's CUDA graph of the thickness pass: over two
    frames' cell splats and a third of another shape (captured anew), the
    replayed map bit for bit the eager deposit and map, one call of each
    counted a replay, and the frame through render_frame_cells the eager
    frame."""
    sc, state, view = flagship
    rc = _rc("default", sc.config, view, thickness_pass=True)
    bg = background_for_view(rc, view, dev)
    step = rpipeline.emitting_frame_fn(sc.config, rc.camera, sc.config.substeps)
    s1, c1 = step(state, sc.fluid, (), view)
    _, c2 = step(s1, sc.fluid, (), view)
    replay = rpipeline._ThicknessReplay(rc, rc.crop)
    for cells in (c1, c2, c2[:, :-7].contiguous()):
        want = rssfr.thickness_map(
            rsplat.thickness_deposit(cells, rc.camera, rc.ssfr.particle_sphere_radius,
                                     crop=rc.crop), rc.ssfr)
        calls = rsplat.thickness_deposits, rssfr.thickness_maps
        got = replay(cells)
        assert (rsplat.thickness_deposits - calls[0], rssfr.thickness_maps - calls[1]) == (1, 1)
        assert torch.equal(got, want)
        assert bool((want > rc.ssfr.thickness).any())
        frame = rpipeline.render_frame_cells(cells, view, rc, bg=bg, thickness_pass=replay)
        assert torch.equal(frame, rpipeline.render_frame_cells(cells, view, rc, bg=bg))


def _write_faces(d) -> None:
    """Six 64x64 gradient cubemap faces `sky-1.png .. sky-6.png` in `d`."""
    ramp = np.linspace(0, 255, 64).astype(np.uint8)
    for i in range(1, 7):
        face = np.stack([np.broadcast_to(ramp[:, None], (64, 64)),
                         np.full((64, 64), 40 * i, np.uint8),
                         np.broadcast_to(ramp[None, ::-1], (64, 64))], -1)
        write_png(os.path.join(d, f"sky-{i}.png"), np.ascontiguousarray(face))


def test_particle_array_frame_with_a_png_cubemap(dev, flagship, plain_chain, tmp_path):
    """render_frame of the live slots at ratio 0.5 under a cubemap read from
    PNG faces: bit for bit the plain chain; one dilation, BL and SH launch;
    unlike the same frame over the sky."""
    sc, state, view = flagship
    _write_faces(tmp_path)
    faces = load_cubemap(str(tmp_path), dev)
    assert tuple(faces.shape) == (6, 64, 64, 3) and faces.device.type == "cuda"
    rc = RenderConfig(camera=CAM, sphere_render_ratio=0.5)
    bg = background_for_view(rc, view, dev)
    pos, vmag = live_particles(state)

    def draw(cube=faces):
        return frame_to_u8(render_frame(pos, vmag, view, rc, cubemap_faces=cube, bg=bg))

    img, launched = _launched(draw)
    assert {k: v for k, v in launched.items() if v} == {"splat_dilate": 1, "blur_depth": 1,
                                                         "ssfr_shade": 1}
    with plain_chain():
        plain = draw()
    assert torch.equal(img, plain), int((img != plain).any(dim=-1).sum())
    assert not torch.equal(img, draw(None))
    assert _fluid_share(img, bg, rc) >= 0.01


def test_orbit_camera_frames_equal_the_plain_chain(dev, flagship, plain_chain):
    """The frame loop under a camera circling the fluid, as `render
    --orbit-camera` moves it: no crop, the background traced each frame;
    six frames a sixth of a turn apart, each with the due launches and bit
    for bit the plain chain's, states too."""
    sc, state, _ = flagship
    frame = make_full_frame_step(sc.config, RenderConfig(camera=CAM), sc.config.substeps)
    sk = sp = state
    imgs = []
    for i in range(6):
        ang = 2.0 * np.pi * i / 6
        view = torch.from_numpy(look_at((16.0 + 40.0 * np.cos(ang), 34.0,
                                         16.0 + 40.0 * np.sin(ang)), (16.0, 10.0, 16.0)))
        (sk, img), launched = _launched(lambda: frame(sk, sc.fluid, (), view, None))
        assert launched == due_launches("default", sc.config.substeps)
        with plain_chain():
            sp, plain = frame(sp, sc.fluid, (), view, None)
        assert torch.equal(img, plain), (i, int((img != plain).any(dim=-1).sum()))
        assert_states_equal(sk, sp)
        imgs.append(img)
    assert float((imgs[0].int() - imgs[3].int()).abs().float().mean()) > 1.0


def _mesh(kind: str) -> domain.SlabMesh:
    """SLABS slabs: all on the first card ("one_card"), or a card each
    where the host has SLABS, else alternating over two ("cards", and
    "cards_peerless": every neighbour on another card); skips with fewer
    than two cards."""
    if kind == "one_card":
        return domain.SlabMesh.on(torch.device("cuda", 0), SLABS)
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    m = n if n >= SLABS else 2
    return domain.SlabMesh.of([torch.device("cuda", a % m) for a in range(SLABS)])


@pytest.fixture
def peer_access(monkeypatch, mesh_kind):
    """With "cards_peerless", every pair of cards reads as having no peer
    access (torch.cuda.can_device_access_peer), so that the exchange takes
    its copy_ fallback; the exchanges and links made that way are dropped
    after the test."""
    def fresh():
        halo_fill.links.cache_clear()
        domain._exchange.cache_clear()

    if mesh_kind == "cards_peerless":
        fresh()
        monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: False)
    yield
    if mesh_kind == "cards_peerless":
        fresh()


def _random_slabs(mesh, k: int, loc: int, pc: int, storage, seed: int):
    """Unpadded slabs of random bits on the mesh's cards (the exchange
    copies bits: any values do), with zero counters."""
    gen = torch.Generator().manual_seed(seed)
    slabs = []
    for d in mesh.devices:
        def rnd(*shape, dtype=torch.float32):
            return torch.randn(*shape, loc * pc, generator=gen).to(dtype).to(d)

        slabs.append(bucketed.BucketState(
            pos=rnd(3, k), vel=rnd(3, k, dtype=storage), C=rnd(3, 3, k, dtype=storage),
            mass=rnd(k), ids=torch.randint(-1, 1 << 20, (k, loc * pc), generator=gen,
                                           dtype=torch.int32).to(d),
            **{f: torch.zeros((), dtype=torch.int32, device=d) for f in domain.COUNTERS}))
    return slabs


def _allocations(mesh) -> list[int]:
    return [torch.cuda.memory_stats(d)["allocation.all.allocated"]
            for d in dict.fromkeys(mesh.devices)]


@pytest.mark.parametrize("storage", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mesh_kind", ["one_card", "cards", "cards_peerless"])
@pytest.mark.parametrize("k, loc, pc", [(3, 7, 19 * 37), (8, 8, 32 * 32)])
def test_halo_fill_matches_plain(dev, mesh_kind, peer_access, storage, k, loc, pc):
    """Kernel HF against its plain version, bit for bit, on 4 slabs of
    random bits: the full exchange (new padded slabs), the in-place state
    halo over scrambled halo planes, both grid exchanges in float32 and
    int32. A 19 x 37 plane leaves 2- and 4-byte words; 32 x 32 16-byte
    ones. The in-place fills allocate nothing on any card. Each exchange
    launches once a slab, and the plain version never; without peer access
    a slab's segments from its neighbours run as copy_ (counted), and only
    the two end slabs, with dead planes to fill, launch an in-place fill."""
    mesh = _mesh(mesh_kind)
    n, nf = mesh.n, len(domain.FIELDS)
    peerless = mesh_kind == "cards_peerless"
    fills = 2 if peerless else n  # launches of an in-place exchange
    crossed = 2 * (n - 1) if peerless else 0  # segments a field copied a side by copy_

    def counts():
        return halo_fill.fill_launches, halo_fill.full_launches, halo_fill.copies

    slabs = _random_slabs(mesh, k, loc, pc, storage, seed=loc)
    c0 = counts()
    got = domain._exchange_state_halo(slabs, pc)
    assert counts() == (c0[0], c0[1] + n, c0[2] + nf * crossed)
    c0 = counts()
    want = domain._exchange_state_halo(slabs, pc, plain=True)
    assert counts() == c0
    for g, w in zip(got, want):
        assert_states_equal(g, w)
    halo = [slice(0, 2 * pc), slice((loc + 2) * pc, (loc + 4) * pc)]

    def scrambled(seed):
        gen = torch.Generator().manual_seed(seed)
        out = []
        for p in got:
            p = p.replace(**{f: getattr(p, f).clone() for f in domain.FIELDS})
            for f in domain.FIELDS:
                x = getattr(p, f)
                for h in halo:
                    x[..., h] = torch.randint(-9, 9, x[..., h].shape, generator=gen).to(x)
            out.append(p)
        return out

    domain._fill_state_halo(scrambled(1), pc)  # the plan and the links made
    gk, gp = scrambled(2), scrambled(2)
    grids = []
    for dtype in (torch.float32, torch.int32):
        for rows in ((), (3,)):
            gen = torch.Generator().manual_seed(len(rows) + 7)
            g = [torch.randint(-99, 99, (*rows, (loc + 6) * pc), generator=gen).to(dtype).to(d)
                 for d in mesh.devices]
            grids.append(([x.clone() for x in g], g))
    for gg, _ in grids:  # the grid plans made
        domain._exchange_grid([x.clone() for x in gg], loc, pc)
    torch.cuda.synchronize()
    a0, c0 = _allocations(mesh), counts()
    domain._fill_state_halo(gk, pc)
    for gg, _ in grids:
        domain._exchange_grid(gg, loc, pc)
    torch.cuda.synchronize()
    assert _allocations(mesh) == a0
    assert counts() == (c0[0] + fills * (1 + len(grids)), c0[1],
                        c0[2] + crossed * (nf + len(grids)))
    c0 = counts()
    domain._fill_state_halo(gp, pc, plain=True)
    for g, w, ref in zip(gk, gp, got):
        assert_states_equal(g, w)
        assert_states_equal(g, ref)  # the same planes as the full exchange's
    for gg, want_g in grids:
        domain._exchange_grid(want_g, loc, pc, plain=True)
        for x, y in zip(gg, want_g):
            assert torch.equal(x, y)
        assert not torch.equal(gg[1][..., :2 * pc], torch.zeros_like(gg[1][..., :2 * pc]))
    assert counts() == c0


def test_sharded_demos_on_slabs_of_one_card(dev):
    """domain.demo_sharded_bucket_step (f32, y-windowed, bf16) and
    demo_sharded_render (whole and y-windowed) on 4 slabs of the card: each
    raises unless it equals its unsharded run."""
    domain.demo_sharded_bucket_step(SLABS, dev)
    demo_sharded_render(SLABS, dev)


@pytest.mark.parametrize("case", ["default", "velocity_spheres", "thickness"])
def test_sharded_frame_equals_the_unsharded_frame(dev, case):
    """make_sharded_frame_step on 4 slabs of the card, on the pool's frozen
    window: the shard kernels and the emission launch, P does not; the
    gathered state equals the unsharded frame step's; the frame too, bit for
    bit, where the slabs composite by a min (the thickness deposit sums
    over slabs: within 0.5 mean u8 levels); two calls give the same bits."""
    sc, win, state, view = _pool(dev)
    cfg = win.config
    mode, ssfr = MODES[case]
    rc = _rc(mode, sc.config, view, **ssfr)
    bg = background_for_view(rc, view, dev)
    mesh = domain.SlabMesh.on(dev, SLABS)
    sframe = make_sharded_frame_step(cfg, mesh, rc, sc.config.substeps)

    def sharded():
        return sframe(domain.shard_bucket_state(state, cfg, mesh), sc.fluid, (), view, bg)

    (ss, img), launched = _launched(sharded)
    ran = ["p2g1_shard", "p2g2u_shard", "g2p_migrate_shard", "g2p_migrate_emit"]
    ran += [] if mode == "velocity_spheres" else ["blur_depth", "ssfr_shade"]
    assert min(launched[k] for k in ran) > 0 and launched["p2g_update"] == 0, launched
    substeps = sc.config.substeps  # a full exchange a slab, then 3 S - 1 in-place fills
    assert launched["halo_full"] == SLABS, launched
    assert launched["halo_fill"] == SLABS * (3 * substeps - 1), launched
    assert torch.equal(img, sharded()[1])
    ref, want = make_full_frame_step(cfg, rc, sc.config.substeps)(state, sc.fluid, (), view, bg)
    assert_states_equal(domain.gather_bucket_state(ss), ref)
    assert int(ss.lost) == int(state.lost) and int(ss.ceiling) == 0
    if ssfr:
        assert float((img.int() - want.int()).abs().float().mean()) < 0.5
    else:
        assert torch.equal(img, want), int((img != want).any(dim=-1).sum())
    assert _fluid_share(img, bg, rc) >= 0.01


@pytest.mark.parametrize("mesh_kind", ["one_card", "cards"])
def test_sharded_air_window_equals_the_unsharded_window(dev, mesh_kind):
    """Config 5's windows (utils/profile_shard) on the pool cut to 32^3: 150
    settle substeps of the air window on 4 slabs of the card (or of
    distinct cards, their halos read card to card), through the shard
    kernels alone, gathered, equal the unsharded window's bit for bit, with
    the same window height, resizes and counters; no particle lost, no
    interference. The slab exchange: a full exchange a slab a chunk of 10
    substeps, then 29 in-place fills."""
    sc, win_u, win_s = config5_windows(dev, n_target=40_000, grid=(32, 32, 32),
                                       mesh=_mesh(mesh_kind))
    su = settle(win_u, win_u.init(sc.state), sc.fluid)
    ss, launched = _launched(lambda: settle(win_s, win_s.init(sc.state), sc.fluid))
    assert min(launched[k] for k in ("p2g1_shard", "p2g2u_shard", "g2p_migrate_shard")) > 0
    assert launched["p2g_update"] == 0, launched
    chunks = 150 // win_s.S
    assert launched["halo_full"] == chunks * SLABS, launched
    assert launched["halo_fill"] == chunks * SLABS * (3 * win_s.S - 1), launched
    check_settled(win_u, su, win_s, ss)
    assert int(su.lost) == 0 and win_u.interference == win_s.interference == 0
    assert state_is_finite(su)


def test_sharded_step_at_k72_equals_the_unsharded_kernels(dev):
    """The dense K = 72 scene (64-slot chunks) on 4 slabs of the card: 3
    sharded substeps equal 3 of kernels P and F slot for slot, each shard
    stage launched once a slab a substep (F counts its shard launches in
    both counts), the slab exchange a full exchange and 8 in-place fills a
    slab, and nothing else."""
    config, fluid, state = dense_scene(3, 72, dev, grid=16, warm=0)
    want = make_step(config, mode="cuda", substeps=3)(state, fluid)
    mesh = domain.SlabMesh.on(dev, SLABS)
    step = domain.make_sharded_bucket_step(config, mesh, substeps=3)
    got, launched = _launched(
        lambda: step(domain.shard_bucket_state(state, config, mesh), fluid))
    n = 3 * SLABS
    assert {k: v for k, v in launched.items() if v} == {
        "p2g1_shard": n, "p2g2u_shard": n, "g2p_migrate_shard": n, "g2p_migrate": n,
        "halo_full": SLABS, "halo_fill": SLABS * (3 * 3 - 1)}
    assert_states_equal(domain.gather_bucket_state(got), want)


def _poison(state):
    """A NaN in one live slot's position."""
    k, c = np.unravel_index(int(torch.argmax(state.mass)), tuple(state.mass.shape))
    pos = state.pos.clone()
    pos[0, int(k), int(c)] = float("nan")
    return state.replace(pos=pos)


def test_guard_rolls_a_poisoned_state_back(dev):
    """GuardedStep(snapshot_every=32, check_every=8) around the pool
    window's chunks: 16 healthy calls, no failure, nothing lost; then a
    step that poisons pos with a NaN at call 20 of 40: the guard rolls back
    once to a verified snapshot, halves dt, and its last good state is
    finite."""
    sc, win, state, _ = _pool(dev)
    guarded = GuardedStep(win.step, snapshot_every=32, check_every=8)
    s = state
    for _ in range(16):
        s = guarded(s, sc.fluid)
    assert guarded.flush() and guarded.failures == 0 and int(s.lost) == int(state.lost)
    calls = [0]

    def flaky(st, fp, inter=()):
        calls[0] += 1
        out = win.step(st, fp, inter)
        return _poison(out) if calls[0] == 20 else out

    g = GuardedStep(flaky, snapshot_every=32, check_every=8)
    s = state
    for _ in range(40):
        s = g(s, sc.fluid)
    if not g.flush():
        s = g.last_good()
    assert g.failures == 1 and g.current_dt_scale == 0.5
    assert state_is_finite(g.last_good()) and state_is_finite(s)


def _pool_1m(dev):
    """(scene, window, state): the 1M benchmark pool (64^3, K=8, bf16 vel/C)
    under its air window (chunks of 10 substeps, headroom 4) after 150
    settle substeps."""
    sc = benchmark_scene(1_000_000, device=dev)
    win = YWindow(sc.config, mode="cuda", substeps=10, headroom=4)
    return sc, win, settle(win, win.init(sc.state), sc.fluid)


def _orbit_sphere(config, frame: int) -> Interaction:
    """`run --orbit-sphere`'s sphere at `frame` (mpm_tpu_torch/__main__.py):
    radius max(4, width / 8), strength 1, a turn in 120 frames a quarter of
    the width from the middle, a fifth of the height up."""
    res = np.asarray(config.grid_res, np.float32)
    ang = 2.0 * np.pi * frame / 120.0
    centre = res / 2.0
    centre[0] += res[0] / 4.0 * np.cos(ang)
    centre[2] += res[0] / 4.0 * np.sin(ang)
    centre[1] = res[1] / 5.0
    return Interaction.sphere(centre, radius=max(4.0, float(res[0]) / 8.0), strength=1.0)


def _spheres(lo, hi, n: int, seed: int) -> tuple:
    """n seeded spheres with centres in the box [lo, hi), both kinds: the
    sphere's constant push (strength 0.1-0.5) and the mouse's radius / |d|
    falloff (0.02-0.1); the sixth inactive."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        make, s_lo, s_hi = ((Interaction.sphere, 0.1, 0.5) if i % 2
                            else (Interaction.mouse, 0.02, 0.1))
        out.append(make(rng.uniform(lo, hi).astype(np.float32).tolist(),
                        radius=float(rng.uniform(3.0, 6.0)),
                        strength=float(rng.uniform(s_lo, s_hi)), active=0.0 if i == 5 else 1.0))
    return tuple(out)


def test_spheres_on_the_air_window(dev):
    """Kernel F on the 1M pool's settled window with `run --interact
    sphere=32,10,32,6 --interact sphere=8,70,56,5,0.5 --orbit-sphere`'s
    three spheres at frame 7, and with 12 seeded spheres: bit for bit its
    plain version each time, and the spheres push; the fly pointer's
    inactive sphere changes no bit. Then from the settled pool, each on a
    window of its own, 10 chunks with the orbit sphere moving each chunk,
    and 10 with the 12: P and F launch, no particle lost, no interference,
    positions finite."""
    sc, win, state = _pool_1m(dev)
    cfg, fluid = win.config, sc.fluid
    static = (Interaction.sphere((32.0, 10.0, 32.0), radius=6.0),
              Interaction.sphere((8.0, 70.0, 56.0), radius=5.0, strength=0.5))
    three = static + (_orbit_sphere(sc.config, 7),)
    twelve = _spheres((8.0, 4.0, 8.0), (56.0, 14.0, 56.0), 12, 5)
    grid = kp.p2g_update_plain(state, cfg, fluid)
    bare = kf.g2p_migrate(state, grid, cfg, fluid)
    for inter in (three, twelve):
        got = kf.g2p_migrate(state, grid, cfg, fluid, inter)
        assert_states_equal(got, kf.g2p_migrate_plain(state, grid, cfg, fluid, inter))
        assert bool((got.vel != bare.vel).any())
    pointer = (SpherePointer(sc.config).interaction(),)
    assert_states_equal(kf.g2p_migrate(state, grid, cfg, fluid, three + pointer),
                        kf.g2p_migrate(state, grid, cfg, fluid, three))
    del grid, bare
    for inter_at in (lambda i: static + (_orbit_sphere(sc.config, i),), lambda i: twelve):
        _, win, state = _pool_1m(dev)

        def chunks():
            s = state
            for i in range(10):
                s = win.step(s, fluid, inter_at(i))
            return s

        s, launched = _launched(chunks)
        assert min(launched["p2g_update"], launched["g2p_migrate"]) > 0
        assert int(s.lost) == int(state.lost) and win.interference == 0 and state_is_finite(s)


# ---- each kernel beside its plain version at the scenes of its main path --

def _plain_substeps(state, config, fluid, n: int):
    for _ in range(n):
        state = bucketed.substep(state, config, fluid)
    return state


def _flagship_64(dev, fixed: bool = False):
    """fluid_3d at its full size (157,464 particles, 64^3, K=16, f32; with
    `fixed` an int32 grid) after 3 plain substeps."""
    sc = fluid_3d(device=dev)
    config = sc.config.replace(fixed_point=fixed)
    return config, sc.fluid, _plain_substeps(bucketed.from_simstate(sc.state, config), config,
                                             sc.fluid, 3)


def _check_p_and_f(config, fluid, state):
    """Kernel P (one launch) within 1e-5 of the grid's largest |value|, bit
    for bit on an int32 grid; kernel F (one launch) from P's plain grid at
    F's bars. Returns the plain grid."""
    got, launched = _launched(lambda: kp.p2g_update(state, config, fluid))
    want = kp.p2g_update_plain(state, config, fluid)
    if config.fixed_point:
        assert int(want.mom.abs().max()) > 0
        assert torch.equal(got.mom, want.mom) and torch.equal(got.mass, want.mass)
    else:
        scale = float(want.mom.abs().max())
        assert scale > 0
        torch.testing.assert_close(got.mom, want.mom, rtol=0, atol=1e-5 * scale)
        torch.testing.assert_close(got.mass, want.mass, rtol=0, atol=1e-5)
    out, launched_f = _launched(lambda: kf.g2p_migrate(state, want, config, fluid))
    assert launched["p2g_update"] == launched_f["g2p_migrate"] == 1
    assert_states_close(out, kf.g2p_migrate_plain(state, want, config, fluid),
                        config.vc_dtype == torch.bfloat16)
    return want


def _check_render_kernels(config, fluid, state, view, grid):
    """Kernel X and F's emission at 640x360 under `view`, as the windowed
    and the frame paths draw: X's splats at X's bar, some live; the
    emitting substep's state at F's bars and its splats at X's bar."""
    cam = Camera(width=640, height=360)
    got = kx.extract_cell_splats(state, view, cam)
    want = kx.extract_cell_splats_plain(state, view, cam)
    assert int((want[2] < kx.CELL_BG).sum()) > 0
    assert_splats_equal(got, want)
    rs = kx.render_scals_for(view, cam)
    out, splats = kf.g2p_migrate(state, grid, config, fluid, emit_splats=True, render_scals=rs)
    plain = kf.g2p_migrate_plain(state, grid, config, fluid)
    assert_states_close(out, plain, config.vc_dtype == torch.bfloat16)
    assert_splats_equal(splats, cell_splats_plain(plain.pos, plain.vel, plain.mass, rs))


def _perturbed(state, config, seed: int = 3):
    """The state with its particles moved along every axis (uniform +-0.9
    cells) and, in the cells of even x, y and z of the middle third, all
    moved up a cell on each axis, so that kernel E's moves crowd cells past
    K."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    occ = state.mass > 0
    d = (torch.rand(tuple(state.pos.shape), generator=gen) * 1.8 - 0.9).to(state.pos.device)
    pos = torch.clamp(state.pos + torch.where(occ, d, 0.0), 2.0, min(config.grid_res) - 2.5)
    cell = bucketed.cell_coords(config, state.pos.device)
    lo, hi = config.grid_res[0] // 3, 2 * config.grid_res[0] // 3
    push = (cell % 2 == 0).all(dim=0) & (cell >= lo).all(dim=0) & (cell <= hi).all(dim=0)
    pos = torch.where(occ & push, torch.floor(state.pos) + 1.5, pos)
    return state.replace(pos=pos.contiguous())


def _case_fluid_3d(dev):
    """P and F, X and F's emission under default_view, the per-pass A, B
    and D bit for bit, E bit for bit after the plain tail and on a
    crowded state that defers moves."""
    config, fluid, state = _flagship_64(dev)
    grid = _check_p_and_f(config, fluid, state)
    _check_render_kernels(config, fluid, state, default_view(config.grid_res), grid)
    g1, w1 = planes.p2g1_planes(state, config), planes.p2g1_plain(state, config)
    assert torch.equal(g1.mass, w1.mass) and torch.equal(g1.mom, w1.mom)
    assert torch.equal(planes.p2g2_planes(state, w1.mass, config, fluid),
                       planes.p2g2_plain(state, w1.mass, config, fluid))
    vel, C = planes.g2p_planes(state, grid, config)
    wvel, wC = planes.g2p_plain(state, grid, config)
    assert torch.equal(vel, wvel) and torch.equal(C, wC)
    crowded = _perturbed(state, config)
    for pre in (bucketed.g2p_bucketed(state, grid, config, fluid), crowded):
        got, want = ke.migrate_planes(pre, config), ke.migrate_planes_plain(pre, config)
        for f in ("pos", "vel", "C", "mass", "ids", "lost", "deferred"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(ke.migrate_planes_plain(crowded, config).deferred) > 0


def _case_fluid_3d_fixed(dev):
    """P and F on an int32 grid."""
    _check_p_and_f(*_flagship_64(dev, fixed=True))


def _case_s4_fixed(dev):
    """P and F on S4 (fluid_3d_fixed_point: 32^3, K=8, int32 grid) after 5
    plain substeps."""
    sc = fluid_3d_fixed_point(device=dev)
    _check_p_and_f(sc.config, sc.fluid, _plain_substeps(
        bucketed.from_simstate(sc.state, sc.config), sc.config, sc.fluid, 5))


def _case_pool_1m(dev):
    """P and F (bf16 vel/C, K=8), X and F's emission under the pool's view,
    on the 1M pool's settled window."""
    sc, win, state = _pool_1m(dev)
    grid = _check_p_and_f(win.config, sc.fluid, state)
    _check_render_kernels(win.config, sc.fluid, state, default_view(sc.config.grid_res), grid)


def _case_dam_1m(dev):
    """P and F (bf16 vel/C, K=8, the whole 64 x 112 x 64 grid) on the 1M
    dam-break at substep 60, where the benchmark's replay starts, and at
    substep 200, mid-collapse, after chunks of 10 kernel substeps in which
    kernel F deferred moves, F's one launch there deferring more. F's
    counters, `cfl_clamped` among them (no particle of the dam moves more
    than a cell in a substep up to there: it reads 0), equal the plain
    version's."""
    sc = benchmark_dam_break(1_000_000, device=dev)
    config, fluid = sc.config, sc.fluid
    step = make_step(config, mode="cuda", substeps=10)
    state = bucketed.from_simstate(sc.state, config)
    for _ in range(6):
        state = step(state, fluid)
    _check_p_and_f(config, fluid, state)
    at60 = int(state.deferred)
    for _ in range(14):
        state = step(state, fluid)
    assert int(state.lost) == 0 and int(state.deferred) > at60
    grid = _check_p_and_f(config, fluid, state)
    assert int(kf.g2p_migrate_plain(state, grid, config, fluid).deferred) > int(state.deferred)


def _case_bench2d(dev):
    """sim2d at F's bars, mass and ids equal, and migrate2d on its plain
    output, on the 2D benchmark (100k particles, 256^2, K=4) after 20 plain
    substeps; sim2d with 12 seeded spheres bit for bit."""
    sc = benchmark_scene_2d(device=dev)
    config, fluid = sc.config, sc.fluid
    state = _plain_substeps(bucketed.from_simstate(sc.state, config), config, fluid, 20)
    got, launched = _launched(lambda: k2d.sim2d(state, config, fluid))
    moved = k2d.sim2d_plain(state, config, fluid)
    assert_states_close(got, moved, False)
    assert torch.equal(got.mass, moved.mass) and torch.equal(got.ids, moved.ids)
    out, launched_m = _launched(lambda: k2d.migrate2d(moved, config))
    want = k2d.migrate2d_plain(moved, config)
    assert_states_close(out, want, False)
    assert torch.equal(out.mass, want.mass)
    assert launched["sim2d"] == launched_m["migrate2d"] == 1
    twelve = _spheres((40.0, 40.0), (216.0, 216.0), 12, 6)
    got = k2d.sim2d(state, config, fluid, twelve)
    assert_states_equal(got, k2d.sim2d_plain(state, config, fluid, twelve))
    assert bool((got.vel != moved.vel).any())


def _case_dense(dim: int, k: int, grid: int, fit: bool = False):
    """The dense scene of tests/torch_wide_cases.py at K = k (cells of more
    than 64 particles, and above K = 64 the kernels' 64-slot chunks; `fit`:
    at most 64 a cell, the same particles at every K): 2 substeps through
    mode="cuda", each kernel launched twice, bit for bit 2 plain substeps;
    on that state each kernel bit for bit its plain version."""
    def case(dev):
        config, fluid, s0 = dense_scene(dim, k, dev, grid=grid, warm=0, fit=fit)
        fullest = int((s0.mass > 0).sum(0).max())
        assert fullest <= 64 if fit else fullest > 64
        names = ("p2g_update", "g2p_migrate") if dim == 3 else ("sim2d", "migrate2d")
        state, launched = _launched(lambda: make_step(config, mode="cuda", substeps=2)(s0, fluid))
        assert {n: v for n, v in launched.items() if v} == dict.fromkeys(names, 2)
        assert_states_equal(state, make_step(config, mode="bucketed", substeps=2)(s0, fluid))
        if dim == 3:
            want = kp.p2g_update_plain(state, config, fluid)
            got = kp.p2g_update(state, config, fluid)
            assert torch.equal(got.mom, want.mom) and torch.equal(got.mass, want.mass)
            assert_states_equal(kf.g2p_migrate(state, want, config, fluid),
                                kf.g2p_migrate_plain(state, want, config, fluid))
        else:
            moved = k2d.sim2d_plain(state, config, fluid)
            assert_states_equal(k2d.sim2d(state, config, fluid), moved)
            assert_states_equal(k2d.migrate2d(moved, config), k2d.migrate2d_plain(moved, config))
    return case


# case: the main path and the scene it gives the kernels
MAIN_PATH_CASES = {
    "fluid_3d": _case_fluid_3d,  # the flagship sim and its frame; the per-pass engine
    "fluid_3d_fixed": _case_fluid_3d_fixed,
    "s4_fixed": _case_s4_fixed,  # `run fluid_3d_fixed_point`
    "pool_1m": _case_pool_1m,  # the air window, `render --window auto`
    "dam_1m": _case_dam_1m,  # the benchmark's dam_1m.sim: no window, bf16, moving occupancy
    "bench2d": _case_bench2d,  # `run bench2d`
    "dense_k72_3d": _case_dense(3, 72, 32),
    "dense_k128_3d": _case_dense(3, 128, 32),
    "dense_k72_2d": _case_dense(2, 72, 128),
    "fit_k64_3d": _case_dense(3, 64, 32, fit=True),
    "fit_k72_3d": _case_dense(3, 72, 32, fit=True),
    "fit_k128_3d": _case_dense(3, 128, 32, fit=True),
}


@pytest.mark.parametrize("case", list(MAIN_PATH_CASES))
def test_kernels_match_plain_at_main_path_scale(dev, case):
    """Each kernel once beside its plain version at the shapes its main path
    gives it, at the card tests' bars (tests/test_torch_cuda.py holds the
    same kernels at 16^3 and 32^2, and their corner cases)."""
    MAIN_PATH_CASES[case](dev)


def test_2d_frame_on_the_card(dev):
    """render_2d of dam_break_2d at spacing 0.5 after 4 kernel substeps: 8
    pixels a cell, the fluid on more than half of its particles' bounding
    box."""
    sc = dam_break_2d(spacing=0.5, device=dev)
    res = sc.config.grid_res
    state, launched = _launched(lambda: make_step(sc.config, mode="cuda", substeps=4)(
        bucketed.from_simstate(sc.state, sc.config), sc.fluid))
    assert launched["sim2d"] == launched["migrate2d"] == 4
    img = frame_to_u8(bucket_frame_2d(state, res))
    empty = frame_to_u8(render_2d(torch.zeros((2, 0), device=dev), torch.zeros(0, device=dev),
                                  res))
    assert tuple(img.shape) == (res[1] * 8, res[0] * 8, 3)
    lp = state.pos[:, state.mass > 0] * 8
    x0, y0 = (int(v) for v in lp.amin(dim=1))
    x1, y1 = (int(v) for v in lp.amax(dim=1))
    diff = (img.int() - empty.int()).abs().amax(dim=-1)[y0:y1 + 1, x0:x1 + 1]
    assert float((diff > 2).float().mean()) > 0.5


def test_binned_engine_conserves_mass_and_ids(dev):
    """mode="binned" on the card over 100 substeps: the mass exactly kept,
    every id once, positions finite."""
    sc = fluid_3d(grid_res=16, box=8.0, spacing=0.8, device=dev)
    n = sc.state.num_particles
    step = make_step(sc.config, mode="binned", substeps=10)
    st = sc.state
    for _ in range(10):
        st = step(st, sc.fluid)
    assert float(st.mass.double().sum()) == float(sc.state.mass.double().sum())
    assert torch.equal(torch.sort(st.ids).values, torch.arange(n, dtype=st.ids.dtype, device=dev))
    assert bool(torch.isfinite(st.pos).all())


def _png_filters(path: str) -> set:
    """The row filter bytes of an 8-bit RGB PNG file."""
    data = open(path, "rb").read()
    pos, idat, w = 8, b"", 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w = struct.unpack(">I", body[:4])[0]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    return set(zlib.decompress(idat)[::w * 3 + 1])


def test_native_png_of_a_card_frame(dev, flagship, tmp_path):
    """The frame-I/O library builds and loads on the card's host; a
    1920x1080 card frame written by write_png reads back equal, its rows
    the native encoder's (filter 0, then 2)."""
    assert native.available(), native.build_error
    sc, state, _ = flagship
    view = default_view(sc.config.grid_res)
    rc = domain_crop(RenderConfig(camera=Camera(width=1920, height=1080)), sc.config, view)
    _, img = make_full_frame_step(sc.config, rc, sc.config.substeps)(
        state, sc.fluid, (), view, background_for_view(rc, view, dev))
    path = str(tmp_path / "frame.png")
    write_png(path, img.cpu().numpy())
    assert np.array_equal(read_png_rgb(path), img.cpu().numpy())
    assert _png_filters(path) == {0, 2}


NINE = [a for i in range(9) for a in ("--interact", f"sphere={8 + 6 * i},12,32,5,0.5")]
# case: (argv, kernels that must launch, kernels that must not, text the run prints);
# `render` writes 3 frames of 320x180 into a temporary directory
CLI_CASES = {
    "run_window": (["run", "fluid_3d", "--window", "auto"], ("p2g_update", "g2p_migrate"),
                   ("g2p_migrate_emit",), "air-window engine: wy="),
    "run_shards": (["run", "fluid_3d", "--shards", "1", "--window", "auto"],
                   ("p2g1_shard", "p2g2u_shard", "g2p_migrate_shard"), ("p2g_update",),
                   "mesh: 1 x-slab shard(s) over cuda devices"),
    "run_per_pass": (["run", "fluid_3d"],
                     ("p2g1_planes", "p2g2_planes", "g2p_planes", "migrate_planes"),
                     ("p2g_update", "g2p_migrate"), "particle-steps/s on cuda"),
    "run_fixed_point": (["run", "fluid_3d_fixed_point"], ("p2g_update", "g2p_migrate"),
                        ("p2g1_planes",), "particle-steps/s on cuda"),
    "run_bench2d": (["run", "bench2d"], ("sim2d", "migrate2d"), ("p2g_update",),
                    "particle-steps/s on cuda"),
    "run_nine_spheres": (["run", "fluid_3d", "--window", "auto", *NINE],
                         ("p2g_update", "g2p_migrate"), (), "interactions=9"),
    "run_binned": (["run", "fluid_3d", "--mode", "binned"], (), ("p2g_update",),
                   "particle-steps/s on cuda"),
    "run_reference": (["run", "dam_break_2d", "--mode", "reference"], (), ("sim2d",),
                      "particle-steps/s on cuda"),
    "render_default": (["render", "fluid_3d"],
                       ("g2p_migrate_emit", "splat_zbuffer", "splat_dilate", "blur_depth",
                        "ssfr_shade"), ("extract_cells",), "with render on cuda"),
    "render_window": (["render", "fluid_3d", "--window", "auto"],
                      ("p2g_update", "extract_cells", "splat_dilate", "blur_depth",
                       "ssfr_shade"), ("g2p_migrate_emit",), "window: wy="),
    "render_shards": (["render", "fluid_3d", "--shards", "1"],
                      ("g2p_migrate_emit", "g2p_migrate_shard", "blur_depth", "ssfr_shade"),
                      ("p2g_update",), "mesh: 1 x-slab shard(s) over cuda devices"),
    "render_velocity": (["render", "fluid_3d", "--render-mode", "velocity_spheres"],
                        ("g2p_migrate_emit", "splat_zbuffer", "splat_dilate"),
                        ("blur_depth", "ssfr_shade"), "render-mode=velocity_spheres"),
    "render_thickness": (["render", "fluid_3d", "--thickness-pass"],
                         ("g2p_migrate_emit", "blur_depth", "ssfr_shade"), (),
                         "thickness-pass=True"),
    "render_ratio": (["render", "fluid_3d", "--sphere-render-ratio", "0.5"],
                     ("p2g_update", "splat_dilate", "blur_depth", "ssfr_shade"),
                     ("g2p_migrate_emit", "splat_zbuffer"), "sphere-render-ratio=0.5"),
    "render_cubemap": (["render", "fluid_3d", "--cubemap", "FACES"],
                       ("g2p_migrate_emit", "blur_depth", "ssfr_shade"), (), "cubemap="),
    "render_legacy_quad": (["render", "fluid_3d", "--render-mode", "legacy_quad"],
                           ("p2g_update", "g2p_migrate"), ("blur_depth",),
                           "render-mode=legacy_quad"),
    "render_binned_ratio": (["render", "fluid_3d", "--mode", "binned",
                             "--sphere-render-ratio", "0.5"], ("blur_depth", "ssfr_shade"),
                            ("p2g_update",), "with render on cuda"),
    "render_orbit_hud": (["render", "fluid_3d", "--orbit-camera", "--hud"],
                         ("g2p_migrate_emit", "blur_depth"), (), "camera=moving"),
    "render_fly_hud": (["render", "fluid_3d", "--fly-script", "wp:1,l:2", "--fly-look-rate",
                        "20", "--hud"],
                       ("g2p_migrate_emit", "blur_depth"), (), "camera=moving"),
    "render_2d_sphere_hud": (["render", "dam_break_2d", "--interact", "sphere=32,20,6", "--hud"],
                             ("sim2d", "migrate2d"), (), "interactions=1"),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_on_the_card(dev, case, tmp_path, capsys, monkeypatch):
    """`python -m mpm_tpu_torch run|render ...` through main(argv) on the
    card (MPM_PALLAS_OLD=1 for the per-pass engine): no particle lost, the
    kernels of the path launched and no other engine's; `render` writes a
    PNG a frame, the fluid drawn over the background, the moving cameras'
    first and last frames apart and the HUD's glyphs drawn."""
    argv, ran, idle, text = CLI_CASES[case]
    if case == "run_per_pass":
        monkeypatch.setenv("MPM_PALLAS_OLD", "1")
    if "FACES" in argv:
        (tmp_path / "faces").mkdir()
        _write_faces(tmp_path / "faces")
        argv = [str(tmp_path / "faces") if a == "FACES" else a for a in argv]
    out = tmp_path / "frames"
    if argv[0] == "render":
        argv = [*argv, "--frames", "3", "--out", str(out), "--width", "320", "--height", "180"]
    else:
        argv = [*argv, "--frames", "3"]
    _, launched = _launched(lambda: cli_main(argv))
    printed = capsys.readouterr().out
    assert text in printed, printed
    assert any(line.startswith(("lost: 0 ", "particles: ")) for line in printed.splitlines())
    assert "finite: False" not in printed
    assert all(launched[k] > 0 for k in ran) and not any(launched[k] for k in idle), launched
    if argv[0] == "run":
        return
    pngs = sorted(out.glob("*.png"))
    assert len(pngs) == 3
    frames = [read_png_rgb(str(p)).astype(np.int32) for p in pngs]
    if "--hud" in argv:
        assert int((frames[-1][:60, :200] == 255).all(axis=-1).sum()) > 0
    if "camera=moving" in text:
        assert float(np.abs(frames[0] - frames[-1]).mean()) > 1.0
    elif argv[1] == "fluid_3d" and "--cubemap" not in argv:
        rc = RenderConfig(camera=CAM)
        bg = frame_to_u8(background_for_view(rc, default_view((64, 64, 64)), dev)[0])
        bg = bg.cpu().numpy().astype(np.int32)
        assert all(int((np.abs(f - bg).max(axis=-1) > 20).sum()) > 0 for f in frames)


def test_cli_run_time_flags_on_the_card(dev, tmp_path, capsys):
    """`run` on the card with the air window, a sphere, the orbiting sphere,
    fluid overrides, gravity flipped at frame 6, metrics, a checkpoint every
    6 frames and the guard; then a resume from its last checkpoint with and
    without the window."""
    ck, met = tmp_path / "ck", tmp_path / "m.jsonl"
    cli_main(["run", "fluid_3d", "--window", "auto", "--frames", "12", "--interact",
              "sphere=32,10,32,6", "--orbit-sphere", "--fluid", "dt=0.15", "--flip-gravity-at",
              "6", "--metrics", str(met), "--checkpoint-every", "6", "--checkpoint-dir", str(ck),
              "--guard"])
    assert "\nlost: 0 " in capsys.readouterr().out
    events = {json.loads(line)["event"] for line in met.read_text().splitlines()}
    assert {"compile", "frame", "guard", "counters", "summary"} <= events
    assert sorted(p.name for p in ck.glob("*.npz")) == ["frame_00006.npz", "frame_00012.npz"]
    for window in (["--window", "auto"], []):
        cli_main(["run", "fluid_3d", "--frames", "3", "--resume", str(ck / "frame_00012.npz"),
                  *window])
        printed = capsys.readouterr().out
        assert "resumed from" in printed and "\nlost: 0 " in printed
