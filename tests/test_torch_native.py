"""The port's native frame-I/O library (mpm_tpu_torch/native) against the
JAX package's (mpm_tpu/native): both built here with g++ and the same
flags, so they are expected to write the same bytes. PNG bytes, files
written by `render/image.write_png`, the u8 tonemap and float blobs are
compared bit for bit, both ways; a decoded PNG equals its input; where the
library cannot be built, write_png takes the standard library and the
build's output is kept."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import mpm_tpu.native as jnative
from mpm_tpu.render import image as jimage
from mpm_tpu_torch import native
from mpm_tpu_torch.models.scenes import dam_break_2d
from mpm_tpu_torch.render import frame_to_u8, image, render_2d

torch.set_num_threads(2)


def _images():
    rng = np.random.default_rng(12)
    noise = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    sc = dam_break_2d(device="cpu")
    vel = torch.sqrt((sc.state.vel * sc.state.vel).sum(0))
    frame = frame_to_u8(render_2d(sc.state.pos, vel, sc.config.grid_res, scale=4)).numpy()
    return {"noise": noise, "frame": frame}


IMAGES = _images()


@pytest.fixture(scope="module", autouse=True)
def jax_library(tmp_path_factory):
    """The JAX package's library built by its own Makefile in a directory
    of this module's, and loaded by its own loader from there: other test
    processes may be running `make` in mpm_tpu/native at the same time."""
    d = tmp_path_factory.mktemp("jax_native")
    src = Path(jnative.__file__).parent
    for f in ("frameio.cpp", "Makefile"):
        shutil.copy(src / f, d / f)
    subprocess.run(["make", "-C", str(d)], check=True, capture_output=True, timeout=120)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH", str(d / "libframeio.so"))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        assert jnative.available()
        yield


def test_the_library_builds_here(monkeypatch):
    """Built and loaded; its file is keyed by the host's CPU as well, so a
    host of other instruction-set extensions builds its own."""
    assert native.available(), native.build_error
    here = native.lib_path()
    assert native.build_error is None and here.exists()
    monkeypatch.setattr(native, "host_isa", lambda: "flags\t\t: fpu sse sse2")
    assert native.lib_path() != here


@pytest.mark.parametrize("level", [1, 6])
@pytest.mark.parametrize("name", list(IMAGES))
def test_encode_png_equals_jax_and_decodes(tmp_path, name, level):
    """Level 1 takes the "up" filter path, level 6 the adaptive filters."""
    img = IMAGES[name]
    got = native.encode_png(img, compress_level=level)
    assert got == jnative.encode_png(img, compress_level=level)
    (tmp_path / "a.png").write_bytes(got)
    np.testing.assert_array_equal(image.read_png_rgb(str(tmp_path / "a.png")), img)


@pytest.mark.parametrize("kind", ["u8", "float", "gray"])
def test_write_png_file_equals_jax(tmp_path, kind):
    rng = np.random.default_rng(5)
    img = {"u8": IMAGES["frame"],
           "float": rng.uniform(-0.2, 1.4, (24, 40, 3)).astype(np.float32),
           "gray": rng.uniform(0.0, 1.0, (24, 40)).astype(np.float32)}[kind]
    image.write_png(str(tmp_path / "port.png"), img)
    jimage.write_png(str(tmp_path / "jax.png"), img)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


def test_tonemap_equals_jax():
    x = np.concatenate([np.linspace(0.0, 1.0, 1 << 18, dtype=np.float32),
                        np.random.default_rng(1).uniform(-1, 2, 4096).astype(np.float32)])
    np.testing.assert_array_equal(native.tonemap_u8(x), jnative.tonemap_u8(x))


def test_blobs_cross_between_the_packages(tmp_path):
    arr = np.random.default_rng(2).standard_normal((3, 7, 11)).astype(np.float32)
    assert native.write_blob(str(tmp_path / "p.bin"), arr)
    np.testing.assert_array_equal(jnative.read_blob(str(tmp_path / "p.bin"), arr.shape), arr)
    assert jnative.write_blob(str(tmp_path / "j.bin"), arr)
    np.testing.assert_array_equal(native.read_blob(str(tmp_path / "j.bin"), arr.shape), arr)
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    assert native.read_blob(str(tmp_path / "p.bin"), (5,)) is None  # another count


def test_stdlib_where_the_library_does_not_build(tmp_path, monkeypatch):
    """A source g++ refuses: the library is unavailable, g++'s output is
    kept, and write_png writes the stdlib encoding of to_uint8's image."""
    bad = tmp_path / "frameio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_error", None)
    assert not native.available()
    assert "frameio.cpp" in native.build_error and "error" in native.build_error
    f = np.random.default_rng(4).uniform(0, 1.5, (6, 9, 3)).astype(np.float32)
    image.write_png(str(tmp_path / "s.png"), f)
    assert (tmp_path / "s.png").read_bytes() == image.encode_png_stdlib(image.to_uint8(f))
