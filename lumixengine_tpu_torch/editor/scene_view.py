"""Scene view (counterpart of
``lumixengine_tpu/editor/scene_view.py``; ≙ reference renderer/editor/scene_view.cpp:1-1856).

The reference's SceneView owns an editor camera (fly navigation, WASD +
mouse), renders the world through the pipeline into its own viewport, and can
toggle game mode. Same surface here: an editor-owned camera entity, a fly
controller driven by the same key state machine as the other views, presents
through the software gpu backend (renderer/gpu_soft.py) — the full DrawStream
replay, so what the editor shows is what the runner shows — and converts the
frame to ANSI half-blocks for the terminal (core/os_terminal.py). 'g' toggles
play (runner ticks the world) vs paused editing (host world state re-uploads,
so transform/property edits show immediately).

The Runner steps on the engine's device (the card unless the engine was
made for the CPU): a paused frame uploads the host world to that device and
steps it with a float32 zero dt there, which runs the cull pass and the
physics solve without advancing the simulation.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from lumixengine_tpu_torch.core import host_math as hm

_UP, _DOWN, _LEFT, _RIGHT = 0x26, 0x28, 0x25, 0x27


class SceneView:
    def __init__(self, engine, world, width: int = 160, height: int = 90):
        self.engine = engine
        self.world = world
        self.width = width
        self.height = height
        self.playing = False
        self.status = ""
        self.move_speed = 2.0        # m per keypress (≙ SceneView m_camera_speed)
        self.turn_speed = 0.1        # rad per keypress
        # terrain brush (≙ terrain_editor raise/lower tool)
        self.brush_radius = 8.0      # heightmap cells
        self.brush_strength = 1.0    # meters per press
        self.brush_dist = 20.0       # brush center this far ahead of camera
        # editor camera: the view owns it, like the reference's SceneView
        # viewport camera (scene_view.cpp editor camera universe entity)
        self.yaw = 0.0
        self.pitch = -0.3
        self.cam_pos = np.array([0.0, 8.0, 24.0], np.float32)
        try:
            self.cam = world.create_entity(name="__editor_camera",
                                           position=tuple(self.cam_pos))
            world.create_component(self.cam, "camera", fov=1.1, near=0.1,
                                   far=10000.0)
        except (RuntimeError, IndexError):
            # world at entity/camera capacity — fly the game camera instead
            rmod = world.modules.get("renderer")
            self.cam = int(getattr(rmod, "active_camera", -1))
            self.status = "world full: flying the game camera"
            p = np.asarray(world.get_local_transform(self.cam)[0], np.float32)
            self.cam_pos = p.copy()
        self._apply_camera()
        self._runner = None
        self._dirty = True           # host world changed → re-upload state
        # overlay hooks: callables returning world-space (p0, p1, rgb)
        # segments drawn over the presented frame (joint gizmos etc. —
        # ≙ the reference's WorldView addLine debug-draw channel)
        self.overlays = []
        self.fov = 1.1
        self.near = 0.1

    # -- camera ----------------------------------------------------------------

    def _apply_camera(self) -> None:
        qy = hm.quat_from_axis_angle(np.array([[0.0, 1.0, 0.0]], np.float32),
                                     np.array([self.yaw], np.float32))[0]
        qx = hm.quat_from_axis_angle(np.array([[1.0, 0.0, 0.0]], np.float32),
                                     np.array([self.pitch], np.float32))[0]
        rot = hm.quat_mul(qy[None], qx[None])[0]
        self._cam_rot = rot
        self.world.set_local_transform(self.cam, position=tuple(self.cam_pos),
                                       rotation=tuple(rot))
        self._dirty = True

    def fly(self, forward: float = 0.0, right: float = 0.0, up: float = 0.0,
            yaw: float = 0.0, pitch: float = 0.0) -> None:
        """Move/turn the editor camera (≙ SceneView::manipulateCamera)."""
        self.yaw += yaw
        self.pitch = float(np.clip(self.pitch + pitch, -1.5, 1.5))
        qy = hm.quat_from_axis_angle(np.array([[0.0, 1.0, 0.0]], np.float32),
                                     np.array([self.yaw], np.float32))[0]
        qx = hm.quat_from_axis_angle(np.array([[1.0, 0.0, 0.0]], np.float32),
                                     np.array([self.pitch], np.float32))[0]
        rot = hm.quat_mul(qy[None], qx[None])[0]
        fwd = hm.quat_rotate(rot[None], np.array([[0.0, 0.0, -1.0]],
                                                 np.float32))[0]
        rgt = hm.quat_rotate(rot[None], np.array([[1.0, 0.0, 0.0]],
                                                 np.float32))[0]
        self.cam_pos = (self.cam_pos + forward * fwd + right * rgt
                        + np.array([0.0, up, 0.0], np.float32))
        self._apply_camera()

    # -- present ----------------------------------------------------------------

    def runner(self):
        """Lazy Runner over the editor's engine+world: builds the fused step
        + snapshot once; paused editing re-snapshots from the host world so
        edits show without rebuilding the step."""
        if self._runner is None:
            from lumixengine_tpu_torch import app as app_mod

            r = app_mod.Runner([], engine=self.engine)
            r.use_world(self.world)
            r.start()
            self._runner = r
            self._dirty = False
        return self._runner

    def frame(self) -> np.ndarray:
        """One editor frame → uint8 [H, W, 3] image."""
        r = self.runner()
        if self.playing:
            pm = self.world.modules.get("physics")
            if pm is not None and pm._statics is None:
                # the physics statics changed under the running simulation
                # (a layer edit in the physics view): its contact layout
                # follows them, so bring the state home and rebuild the step
                r._rebuild_after_structure_change(())
            r.tick()
        elif self._dirty:
            # paused: host world is the source of truth (editor edits)
            r.state = self.world.device_state(r.device)
            self._dirty = False
            # cull with dt=0
            r.state = r.step(r.state, torch.zeros((), dtype=torch.float32, device=r.device))
        img = r.present(cam_slot=self.cam_slot(), width=self.width,
                        height=self.height)
        return self._draw_overlays(img)

    def cam_slot(self) -> int:
        """The editor camera's camera-store slot. (The reference passes the
        entity id, which the present reads as a slot whenever it is below
        the store's capacity: a small world then renders from another
        entity.)"""
        rmod = self.world.modules.get("renderer")
        slot = rmod.cameras.slot_of(self.cam) if rmod is not None else -1
        return slot if slot >= 0 else self.cam

    def _project(self, p: np.ndarray):
        """World → (x_px, y_px, view_z) under the editor camera."""
        v = p - self.cam_pos
        q = self._cam_rot
        conj = np.array([-q[0], -q[1], -q[2], q[3]], np.float32)
        v = hm.quat_rotate(conj[None], v[None].astype(np.float32))[0]
        return v  # view space; z negative in front

    def _draw_overlays(self, img: np.ndarray) -> np.ndarray:
        segs = []
        for hook in self.overlays:
            try:
                segs.extend(hook())
            except Exception:      # an overlay must never kill the present
                continue
        if not segs:
            return img
        h, w = img.shape[0], img.shape[1]
        th = np.tan(self.fov * 0.5)
        aspect = w / max(h, 1)
        img = np.ascontiguousarray(img)
        for p0, p1, rgb in segs:
            a = self._project(np.asarray(p0, np.float32))
            b = self._project(np.asarray(p1, np.float32))
            # clip to the near plane in view space
            if a[2] > -self.near and b[2] > -self.near:
                continue
            if a[2] > -self.near or b[2] > -self.near:
                t = (-self.near - a[2]) / (b[2] - a[2])
                cpt = a + (b - a) * t
                if a[2] > -self.near:
                    a = cpt
                else:
                    b = cpt
            def px(v):
                sx = v[0] / (-v[2] * th * aspect)
                sy = v[1] / (-v[2] * th)
                return (int(round((sx * 0.5 + 0.5) * (w - 1))),
                        int(round((1.0 - (sy * 0.5 + 0.5)) * (h - 1))))
            x0, y0 = px(a)
            x1, y1 = px(b)
            n = max(abs(x1 - x0), abs(y1 - y0), 1)
            xs = np.clip(np.linspace(x0, x1, n + 1).round().astype(int), 0, w - 1)
            ys = np.clip(np.linspace(y0, y1, n + 1).round().astype(int), 0, h - 1)
            inside = ((np.linspace(x0, x1, n + 1) >= 0)
                      & (np.linspace(x0, x1, n + 1) <= w - 1)
                      & (np.linspace(y0, y1, n + 1) >= 0)
                      & (np.linspace(y0, y1, n + 1) <= h - 1))
            img[ys[inside], xs[inside]] = np.asarray(rgb, img.dtype)
        return img

    def mark_dirty(self) -> None:
        """Call after external world edits (EditorApp commands) so the next
        frame re-uploads host state."""
        self._dirty = True

    # -- UI ---------------------------------------------------------------------

    def handle_key(self, code: int, text: str = "") -> None:
        ch = text.lower()
        s, t = self.move_speed, self.turn_speed
        if ch == "w":
            self.fly(forward=s)
        elif ch == "s":
            self.fly(forward=-s)
        elif ch == "a":
            self.fly(right=-s)
        elif ch == "d":
            self.fly(right=s)
        elif ch == "e":
            self.fly(up=s)
        elif ch == "c":
            self.fly(up=-s)
        elif code == _LEFT:
            self.fly(yaw=t)
        elif code == _RIGHT:
            self.fly(yaw=-t)
        elif code == _UP:
            self.fly(pitch=t)
        elif code == _DOWN:
            self.fly(pitch=-t)
        elif ch == "g":                      # toggle game mode (≙ play)
            self.playing = not self.playing
            self.status = "playing" if self.playing else "paused"
        elif ch == "+":
            self.move_speed *= 2.0
        elif ch == "-":
            self.move_speed = max(self.move_speed * 0.5, 0.125)
        elif text == "t":                    # terrain brush: raise
            self.sculpt(+self.brush_strength)
        elif text == "T":                    # terrain brush: lower
            self.sculpt(-self.brush_strength)
        elif ch == "[":
            self.brush_radius = max(self.brush_radius * 0.5, 1.0)
            self.status = f"brush radius {self.brush_radius:.0f} cells"
        elif ch == "]":
            self.brush_radius = min(self.brush_radius * 2.0, 256.0)
            self.status = f"brush radius {self.brush_radius:.0f} cells"

    # -- terrain brush (≙ renderer/editor terrain_editor.cpp raise/lower) ---

    def _terrain_target(self):
        """First terrain component in the world → (entity, tid, registry)."""
        rmod = self.world.modules.get("renderer")
        if rmod is None:
            return None
        st = rmod.terrains
        ents = np.asarray(st.entity)
        tids = np.asarray(st.data["terrain"])
        for e, tid in zip(ents, tids):
            if e >= 0 and tid >= 0:
                return int(e), int(tid), rmod.system.terrains
        return None

    def sculpt(self, amount: float) -> None:
        """Gaussian raise/lower of the first terrain's heightmap at the
        point `brush_dist` ahead of the editor camera. Edits the registry's
        host heights in place — the software raster reads them live
        (gpu_soft.draw_terrain), so the very next frame shows the sculpt;
        physics/navigation pick it up at their next bank rebuild."""
        tgt = self._terrain_target()
        if tgt is None:
            self.status = "no terrain in this world"
            return
        ent, tid, reg = tgt
        tr = reg.get(tid)
        hm_ = tr["heights"]
        # brush center: a fixed distance along the camera forward ray,
        # expressed in terrain-local cells
        fwd = hm.quat_rotate(self._cam_rot[None],
                             np.array([[0.0, 0.0, -1.0]], np.float32))[0]
        center = self.cam_pos + fwd * self.brush_dist
        origin = np.asarray(self.world.get_local_transform(ent)[0],
                            np.float32)
        sc = float(tr.get("xz_scale", 1.0))
        cx = (center[0] - origin[0]) / sc
        cz = (center[2] - origin[2]) / sc
        H, W = hm_.shape
        zz, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        d2 = (xx - cx) ** 2 + (zz - cz) ** 2
        r2 = self.brush_radius ** 2
        hm_ += (amount / max(float(tr.get("y_scale", 1.0)), 1e-6)
                ) * np.exp(-d2 / max(r2 * 0.5, 1e-6)).astype(hm_.dtype)
        self.status = (f"sculpt {'+' if amount >= 0 else ''}{amount:.2f} at "
                       f"cell ({cx:.0f},{cz:.0f}) r={self.brush_radius:.0f}")

    def render_text(self, width: int = 100, height: int = 28) -> str:
        """Compose the presented frame as ANSI half-blocks + a status line.
        Each terminal cell is 2 stacked pixels, so the image renders at
        [2*(height-2), width]."""
        from lumixengine_tpu_torch.core.os_terminal import TerminalWindowBackend

        img_h = max((height - 2) * 2, 2)
        self.width, self.height = max(width, 2), img_h
        img = self.frame()
        ansi = TerminalWindowBackend.ansi_image(img)
        head = (f"scene view — cam ({self.cam_pos[0]:.1f}, "
                f"{self.cam_pos[1]:.1f}, {self.cam_pos[2]:.1f}) "
                f"yaw {self.yaw:.2f} pitch {self.pitch:.2f} "
                f"{'PLAYING' if self.playing else 'paused'} "
                f"speed {self.move_speed:g}")
        foot = (f"[{self.status}]  keys: wasd/ec fly · arrows look · "
                "g play/pause · +/- speed")
        return "\n".join([head.ljust(width)[:width], ansi,
                          foot.ljust(width)[:width]])
