"""Fly camera (port of ``mpm_tpu.render.flycam``): the headless analogue of
the reference's interactive camera.

The reference flies its main camera with right-mouse + mouse-look + WASD
(rendering/objects/main_camera.gd:92-132): look deltas scale at 0.2 deg/px,
pitch clamps at +/-89.9 deg, yaw wraps at 360, and movement is the camera
basis applied to the (left/right, 0, forward/back) input vector, normalized,
at SPEED * delta. This module reproduces those semantics with two input
sources instead of a windowing system:

- `TerminalKeys`: raw-mode stdin polled once per frame (w/a/s/d move,
  arrows or i/j/k/l look, +/- speed) — interactive flight over the live
  render loop from any terminal, no window required. Each pending keypress
  counts as "held for this frame" (terminals report presses, not holds;
  key-repeat supplies the hold stream).
- `ScriptKeys`: a deterministic per-frame key schedule ("w:30,wl:10" =
  30 frames of w, then 10 frames of w+l) — replayable demos and tests.

Poses are host float64 numpy; each frame's view matrix goes to the
renderer as a float32 host matrix, so flying rebuilds nothing.
"""

from __future__ import annotations

import math

import numpy as np

from .camera import look_at


def yaw_pitch_from_forward(fwd) -> tuple[float, float]:
    """Decompose a forward direction into (yaw, pitch) degrees under the
    Godot-style YXZ basis used here: fwd = (-sin(yaw)cos(pitch), sin(pitch),
    -cos(yaw)cos(pitch))."""
    f = np.asarray(fwd, np.float64)
    f = f / np.linalg.norm(f)
    pitch = math.degrees(math.asin(max(-1.0, min(1.0, f[1]))))
    yaw = math.degrees(math.atan2(-f[0], -f[2]))
    return yaw, pitch


class FlyCamera:
    """Pose integrator matching main_camera.gd's _process/_unhandled_input.

    speed: world units per second (the reference's SPEED const, scaled to
    this engine's grid units). look_rate: degrees per frame a look key is
    held (the keyboard analogue of 0.2 deg per mouse px)."""

    def __init__(self, eye, target, speed: float = 40.0,
                 look_rate: float = 2.5):
        self.pos = np.asarray(eye, np.float64).copy()
        self.yaw, self.pitch = yaw_pitch_from_forward(
            np.asarray(target, np.float64) - self.pos)
        self.speed = float(speed)
        self.look_rate = float(look_rate)

    # -- reference semantics ------------------------------------------------

    def look(self, d_yaw: float, d_pitch: float) -> None:
        """current_rotation update (main_camera.gd:110-118): yaw wraps at
        360 (reset-to-zero like the reference), pitch clamps at 89.9."""
        self.yaw += d_yaw
        if abs(self.yaw) > 360.0:
            self.yaw = 0.0
        self.pitch += d_pitch
        if abs(self.pitch) > 89.9:
            self.pitch = math.copysign(89.9, self.pitch)

    def basis(self) -> np.ndarray:
        """Column-vector camera basis Ry(yaw) @ Rx(pitch) (Godot YXZ order
        with zero roll, main_camera.gd:125)."""
        cy, sy = math.cos(math.radians(self.yaw)), math.sin(
            math.radians(self.yaw))
        cp, sp = math.cos(math.radians(self.pitch)), math.sin(
            math.radians(self.pitch))
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
        rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float64)
        return ry @ rx

    def move(self, input_x: float, input_z: float, dt: float) -> None:
        """position += normalize(basis @ (x, 0, z)) * speed * dt
        (main_camera.gd:128-132); input_z = +1 moves backward, matching
        get_vector(move_forward, move_backward)."""
        d = self.basis() @ np.array([input_x, 0.0, input_z], np.float64)
        n = np.linalg.norm(d)
        if n > 1e-9:
            self.pos += (d / n) * self.speed * dt

    # -- per-frame driver ---------------------------------------------------

    def apply_keys(self, keys: str, dt: float) -> None:
        """One frame of held keys: wasd move (w = forward = -z input),
        q/e down/up (an addition the reference lacks — flying a headless
        camera without vertical control is painful), arrows or ijkl look,
        +/- speed."""
        ix = ("d" in keys) - ("a" in keys)
        iz = ("s" in keys) - ("w" in keys)
        if ix or iz:
            self.move(float(ix), float(iz), dt)
        iy = ("e" in keys) - ("q" in keys)
        if iy:
            self.pos[1] += iy * self.speed * dt
        d_yaw = self.look_rate * (("L" in keys or "j" in keys)
                                  - ("R" in keys or "l" in keys))
        d_pitch = self.look_rate * (("U" in keys or "i" in keys)
                                    - ("D" in keys or "k" in keys))
        if d_yaw or d_pitch:
            self.look(d_yaw, d_pitch)
        if "+" in keys:
            self.speed *= 1.25
        if "-" in keys:
            self.speed /= 1.25

    def view(self) -> np.ndarray:
        """World->view [4,4] for the renderer (camera.look_at convention)."""
        fwd = self.basis() @ np.array([0.0, 0.0, -1.0])
        return look_at(self.pos, self.pos + fwd)


class SpherePointer:
    """Steerable interaction sphere — the reference's signature interaction:
    while LMB is held, the sphere collider jumps to the mouse ray's
    intersection with a horizontal plane and pushes the fluid
    (HandleMouseInteraction, MLSMPM3DFluidMultithreadGPU.cs:618-642; the
    SphereMovePlane is a y=0 WorldBoundaryShape3D,
    MLSMPM3DFluidMultithreadGPU.tscn:58-66; force in g2p.glsl:122-129).

    Headless analogue: the fly camera's CENTER ray is the pointer — hold
    SPACE (or 'p', the scriptable token) to place the sphere where the
    crosshair ray meets the plane y = plane_y and push. The Interaction's
    values are read per call by the kernels, so steering rebuilds nothing,
    like the reference's push-constant patch."""

    def __init__(self, config, plane_y: float | None = None,
                 radius: float | None = None, strength: float = 1.0):
        res = [float(r) for r in config.dres]
        self.plane_y = float(plane_y) if plane_y is not None else res[1] / 5.0
        self.radius = float(radius) if radius is not None else max(
            4.0, res[0] / 8.0)
        self.strength = float(strength)
        self._dres = res
        self.center = np.array([res[0] / 2.0, self.plane_y, res[2] / 2.0],
                               np.float64)
        self.active = 0.0

    def update(self, cam: FlyCamera, keys: str) -> None:
        """One frame: SPACE/'p' held = the reference's LMB held (the sphere
        repositions AND pushes only while pressed,
        MLSMPM3DFluidMultithreadGPU.cs:621-631)."""
        pressed = (" " in keys) or ("p" in keys)
        self.active = 1.0 if pressed else 0.0
        if not pressed:
            return
        fwd = cam.basis() @ np.array([0.0, 0.0, -1.0])
        if abs(fwd[1]) < 1e-6:
            return  # ray parallel to the plane: keep the last position
        t = (self.plane_y - cam.pos[1]) / fwd[1]
        if t <= 0.0:
            return  # plane behind the camera
        hit = cam.pos + t * fwd
        # clamp to the physics domain (SimConfig.dres — the TRUE domain,
        # not the array extent)
        self.center = np.minimum(np.maximum(hit, 0.0),
                                 np.asarray(self._dres, np.float64))
        self.center[1] = self.plane_y

    def interaction(self):
        """This frame's Interaction (active gates the force)."""
        from ..ops.interact import Interaction

        return Interaction.sphere(self.center.astype(np.float32),
                                  radius=self.radius,
                                  strength=self.strength,
                                  active=self.active)


# -- input sources ----------------------------------------------------------

_ARROWS = {"A": "U", "B": "D", "C": "R", "D": "L"}  # ESC [ X -> look token


class TerminalKeys:
    """Non-blocking raw-mode stdin key source. poll() drains everything
    pending and returns the set of keys 'held' this frame as a string.
    Arrow escape sequences map to U/D/L/R look tokens. Returns None keys
    and sets .quit on Esc alone or Ctrl-C."""

    def __init__(self):
        import atexit
        import sys
        import termios

        self._fd = sys.stdin.fileno()
        self._saved = termios.tcgetattr(self._fd)
        import tty

        tty.setcbreak(self._fd)
        atexit.register(self.close)  # never leave the terminal raw
        self.quit = False

    def close(self) -> None:
        import termios

        termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)

    def poll(self) -> str:
        import os
        import select

        keys = []
        buf = b""
        while select.select([self._fd], [], [], 0)[0]:
            buf += os.read(self._fd, 64)
        i = 0
        while i < len(buf):
            b = buf[i:i + 1]
            if b == b"\x1b":
                if buf[i + 1:i + 2] == b"[" and len(buf) > i + 2:
                    keys.append(_ARROWS.get(chr(buf[i + 2]), ""))
                    i += 3
                    continue
                self.quit = True  # bare Esc
                i += 1
                continue
            if b == b"\x03":
                self.quit = True
            keys.append(b.decode("ascii", "ignore"))
            i += 1
        return "".join(keys)


class ScriptKeys:
    """Deterministic key schedule: "w:30,wl:10,i:5" -> 30 frames of "w",
    10 of "wl", 5 of "i". An empty segment key ('.') holds still. Used by
    --fly-script and the CLI test."""

    def __init__(self, spec: str):
        self._frames: list[str] = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            keys, _, count = part.partition(":")
            keys = "" if keys == "." else keys
            self._frames += [keys] * int(count or 1)
        self._i = 0
        self.quit = False

    def poll(self) -> str:
        if self._i < len(self._frames):
            k = self._frames[self._i]
            self._i += 1
            return k
        return ""

    def close(self) -> None:
        pass
