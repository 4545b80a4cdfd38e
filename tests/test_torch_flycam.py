"""The port's fly camera (mpm_tpu_torch/render/flycam.py) against the JAX
package's (mpm_tpu/render/flycam.py): the pure-math cases of
tests/test_flycam.py run on both packages, then one ScriptKeys schedule
through both, whose poses, view() matrices and SpherePointer
interactions must be equal."""

import math

import numpy as np
import pytest

from mpm_tpu.core.params import SimConfig as JConfig
from mpm_tpu.render import camera as jcamera
from mpm_tpu.render import flycam as jflycam
from mpm_tpu_torch.core.params import SimConfig as TConfig
from mpm_tpu_torch.render import camera as tcamera
from mpm_tpu_torch.render import flycam as tflycam

PKGS = {"jax": (jflycam, jcamera, JConfig), "torch": (tflycam, tcamera, TConfig)}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def make_cam(fly, **kw):
    return fly.FlyCamera(eye=(32.0, 60.0, 87.0), target=(32.0, 24.0, 32.0), **kw)


def pointer_config(config_cls):
    return config_cls(grid_res=(32, 32, 32), num_particles=8, substeps=1, bin_capacity=8)


def value(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def test_initial_pose_matches_look_at(pkg):
    fly, cam_mod, _ = pkg
    np.testing.assert_allclose(make_cam(fly).view(),
                               cam_mod.look_at((32.0, 60.0, 87.0), (32.0, 24.0, 32.0)),
                               atol=1e-3)


def test_yaw_pitch_roundtrip(pkg):
    fly = pkg[0]
    for fwd in [(0, 0, -1), (1, 0, 0), (0.3, 0.5, -0.2), (-0.7, -0.1, 0.7)]:
        yaw, pitch = fly.yaw_pitch_from_forward(fwd)
        cy, sy = math.cos(math.radians(yaw)), math.sin(math.radians(yaw))
        cp, sp = math.cos(math.radians(pitch)), math.sin(math.radians(pitch))
        rec = np.array([-sy * cp, sp, -cy * cp])
        np.testing.assert_allclose(rec, np.asarray(fwd, float) / np.linalg.norm(fwd), atol=1e-6)


def test_move_is_basis_times_input_normalized(pkg):
    fly = pkg[0]
    cam = make_cam(fly, speed=10.0)
    cam.yaw, cam.pitch = 0.0, 0.0
    p0 = cam.pos.copy()
    cam.apply_keys("w", dt=0.5)
    np.testing.assert_allclose(cam.pos - p0, [0.0, 0.0, -5.0], atol=1e-9)
    cam2 = make_cam(fly, speed=10.0)
    cam2.yaw, cam2.pitch = 0.0, 0.0
    p0 = cam2.pos.copy()
    cam2.apply_keys("wd", dt=0.5)  # diagonal: normalized, still 5 units
    assert abs(np.linalg.norm(cam2.pos - p0) - 5.0) < 1e-9


def test_pitch_clamp_and_yaw_wrap(pkg):
    fly = pkg[0]
    cam = make_cam(fly, look_rate=50.0)
    for _ in range(10):
        cam.apply_keys("i", dt=1 / 60)
    assert cam.pitch == 89.9
    cam.yaw = 0.0
    for _ in range(10):
        cam.apply_keys("j", dt=1 / 60)
    assert abs(cam.yaw) <= 360.0


def test_moving_while_pitched_follows_basis(pkg):
    cam = make_cam(pkg[0], speed=1.0)
    cam.yaw, cam.pitch = 0.0, -30.0
    p0 = cam.pos.copy()
    cam.apply_keys("w", dt=1.0)
    d = cam.pos - p0
    assert d[1] < -0.4 and d[2] < -0.8


def test_script_keys_schedule(pkg):
    src = pkg[0].ScriptKeys("w:3,wl:2,.:1,+:1")
    assert [src.poll() for _ in range(8)] == ["w", "w", "w", "wl", "wl", "", "+", ""]
    assert not src.quit
    src.close()


def test_speed_modifier(pkg):
    cam = make_cam(pkg[0], speed=8.0)
    cam.apply_keys("+", dt=1 / 60)
    assert cam.speed == 10.0
    cam.apply_keys("-", dt=1 / 60)
    assert cam.speed == 8.0


def test_sphere_pointer_ray_plane_math(pkg):
    fly, _, cfg = pkg
    cam = fly.FlyCamera(eye=(10.0, 10.0, 10.0), target=(10.0, 0.0, 0.0))
    ptr = fly.SpherePointer(pointer_config(cfg), plane_y=5.0, radius=4.0)
    ptr.update(cam, "p")
    np.testing.assert_allclose(ptr.center, [10.0, 5.0, 5.0], atol=1e-6)
    assert ptr.active == 1.0
    it = ptr.interaction()
    assert float(value(it.active)) == 1.0 and float(value(it.radius)) == 4.0


def test_sphere_pointer_gates_on_key(pkg):
    fly, _, cfg = pkg
    cam = fly.FlyCamera(eye=(10.0, 10.0, 10.0), target=(10.0, 0.0, 0.0))
    ptr = fly.SpherePointer(pointer_config(cfg), plane_y=5.0)
    c0 = ptr.center.copy()
    ptr.update(cam, "w")  # not pressed: the sphere stays put, inactive
    assert ptr.active == 0.0
    np.testing.assert_array_equal(ptr.center, c0)
    assert float(value(ptr.interaction().active)) == 0.0
    ptr.update(cam, "w ")  # SPACE works like 'p'
    assert ptr.active == 1.0


def test_sphere_pointer_keeps_last_position_when_plane_unreachable(pkg):
    fly, _, cfg = pkg
    ptr = fly.SpherePointer(pointer_config(cfg), plane_y=5.0)
    cam = fly.FlyCamera(eye=(10.0, 10.0, 10.0), target=(10.0, 0.0, 0.0))
    ptr.update(cam, "p")
    hit = ptr.center.copy()
    up = fly.FlyCamera(eye=(10.0, 10.0, 10.0), target=(10.0, 20.0, 10.0 - 1e-5))
    up.pitch = 60.0  # looking up: the plane y=5 is behind the camera
    ptr.update(up, "p")
    np.testing.assert_array_equal(ptr.center, hit)
    assert ptr.active == 1.0


def test_sphere_pointer_clamps_to_domain(pkg):
    fly, _, cfg = pkg
    ptr = fly.SpherePointer(pointer_config(cfg), plane_y=5.0)
    cam = fly.FlyCamera(eye=(16.0, 6.0, 16.0), target=(500.0, 5.0, 16.0))
    ptr.update(cam, "p")
    assert 0.0 <= ptr.center[0] <= 32.0
    np.testing.assert_allclose(ptr.center[1], 5.0)


def test_sphere_pointer_clamps_to_true_domain():
    """A windowed config clamps to domain_res, not the window's arrays."""
    cfg = TConfig(grid_res=(32, 16, 32), domain_res=(32, 64, 32))
    ptr = tflycam.SpherePointer(cfg)
    assert ptr.plane_y == 64 / 5
    cam = tflycam.FlyCamera(eye=(16.0, 40.0, 16.0), target=(16.0, 39.0, 17.0))
    ptr.update(cam, "p")
    assert ptr.center[2] == 32.0 and ptr.center[1] == 64 / 5


SCHEDULE = "w:4,wp:4,l:3,ip:2,.:1,dk:3,+:1,s -:2,eq:2,p:2,jL:2,URD:2"


def _flight(fly, cfg, plane_y=None):
    src = fly.ScriptKeys(SCHEDULE)
    cam = fly.FlyCamera((87.0, 60.0, 87.0), (32.0, 24.0, 32.0), speed=40.0, look_rate=2.5)
    ptr = fly.SpherePointer(cfg(grid_res=(64, 64, 64)), plane_y=plane_y, strength=2.0)
    out = []
    for _ in range(32):
        keys = src.poll()
        cam.apply_keys(keys, 1.0 / 60.0)
        ptr.update(cam, keys)
        it = ptr.interaction()
        out.append((cam.pos.copy(), cam.yaw, cam.pitch, cam.speed, cam.view(),
                    [value(getattr(it, f)) for f in ("center", "radius", "strength",
                                                       "inv_falloff", "active")]))
    return out


@pytest.mark.parametrize("plane_y", [None, 16.0])
def test_script_flight_matches_jax(plane_y):
    """One key schedule through both packages: equal poses, equal view
    matrices, equal pointer interactions, frame by frame."""
    jf, tf = _flight(jflycam, JConfig, plane_y), _flight(tflycam, TConfig, plane_y)
    actives = set()
    for (jp, jy, jpi, js, jv, ji), (tp, ty, tpi, ts, tv, ti) in zip(jf, tf):
        np.testing.assert_array_equal(jp, tp)
        assert (jy, jpi, js) == (ty, tpi, ts)
        assert jv.dtype == tv.dtype == np.float32
        np.testing.assert_array_equal(jv, tv)
        for a, b in zip(ji, ti):
            np.testing.assert_array_equal(a, b)
        actives.add(float(ti[-1]))
    assert actives == {0.0, 1.0}
    assert not np.array_equal(tf[0][0], tf[-1][0])
