"""Viewer render loop: frames in, control state out -- the JAX package's
``gui/viewer.py`` on the port.

The reference couples its editor to the frame loop through AppData (params
applied once per frame as tasks, pick requests forwarded to SceneCore,
camera driven by input events -- Win32App.cpp:609-646). Same shape here:
the HTTP server only mutates ``ViewerState`` under its lock; the render
thread applies pending params, picks, edits and camera deltas at each
frame boundary and publishes the encoded viewport and stats back. The
frames run on the scene's device: the card unless ``device="cpu"``.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ViewerState:
    """Shared state between the render thread and the HTTP server."""

    lock: threading.Lock = field(default_factory=threading.Lock)
    png: bytes = b""
    frame_index: int = 0
    stats: dict = field(default_factory=dict)
    pass_times: dict = field(default_factory=dict)  # per-pass ms (on demand)
    pick_req: tuple | None = None  # (px, py) pending pick
    pick_result: dict | None = None
    picked_instance: int = -1
    cam_delta: list = field(default_factory=lambda: [0.0, 0.0, 0.0])  # yaw, pitch, dolly
    # editor manipulation queues (reference: GuiPass ImGuizmo + material
    # editor, GuiPass.cpp:343-589): applied at the next frame boundary
    transform_req: list = field(default_factory=list)  # dicts, see /api/transform
    material_req: list = field(default_factory=list)  # dicts, see /api/material
    running: bool = True
    profile_req: bool = False
    reload_req: bool = False  # hot reload (dxc-reload analog, gui.reload)
    reload_result: list = field(default_factory=list)

    def publish(self, png: bytes, stats: dict):
        with self.lock:
            self.png = png
            self.frame_index += 1
            self.stats = stats


class Viewer:
    """Owns the scene and the frame loop; drive it with ``run(frames=None)``.

    ``frames=None`` loops until ``state.running`` is cleared (ctrl-C or
    POST /api/quit); an integer renders that many frames then returns.
    ``device``: where the scene and the frames live (default: the card;
    ``native.default_device``).
    """

    def __init__(self, scene_path, cfg, eye=(0, 1.0, 3.5), target=(0, 1.0, 0.0),
                 fov_deg=45.0, textures=True, device=None):
        from .. import native
        from ..app import scene_textures
        from ..scene.gltf import load_gltf
        from ..scene.scene import load_scene, upload_scene

        self.device = native.default_device(device)
        self.cpu = load_scene(load_gltf(scene_path))
        self.scene = upload_scene(self.cpu, self.device)
        self.textures = scene_textures(self.cpu, self.device) if textures else None
        self.cfg_holder = [cfg]
        self.eye = np.asarray(eye, np.float64)
        self.target = np.asarray(target, np.float64)
        self.fov = fov_deg
        self.state = ViewerState()
        self._frame_state = None
        # editor transforms: per-instance accumulated TRS (rest -> now),
        # applied by scene.refit (the reference's ImGuizmo -> TLAS update)
        self._inst_xform = np.tile(np.eye(3, 4, dtype=np.float32),
                                   (len(self.cpu.inst_names), 1, 1))
        self._scene_rest = self.scene
        self._register_params()

    # -- params ------------------------------------------------------------

    def _register_params(self):
        from ..app import _register_params

        _register_params(self.cfg_holder)

    # -- camera ------------------------------------------------------------

    def _camera(self, frame):
        from ..scene.camera import Camera

        cfg = self.cfg_holder[0]
        return Camera.look_at(tuple(self.eye), tuple(self.target), vfov_deg=self.fov,
                              aspect=cfg.width / cfg.height).with_jitter(frame)

    def _apply_camera_delta(self, dyaw, dpitch, ddolly):
        """Orbit eye around target (editor-style turntable) + dolly."""
        rel = self.eye - self.target
        r = float(np.linalg.norm(rel)) or 1e-6
        yaw = math.atan2(rel[0], rel[2]) + dyaw
        pitch = math.asin(np.clip(rel[1] / r, -1.0, 1.0)) + dpitch
        pitch = float(np.clip(pitch, -1.45, 1.45))
        r = float(np.clip(r * math.exp(ddolly), 0.05, 1e6))
        self.eye = self.target + r * np.asarray(
            [math.cos(pitch) * math.sin(yaw), math.sin(pitch), math.cos(pitch) * math.cos(yaw)]
        )

    # -- pick --------------------------------------------------------------

    def _do_pick(self, px, py, camera):
        from ..render.picking import pick

        cfg = self.cfg_holder[0]
        px = int(np.clip(px, 0, cfg.width - 1))
        py = int(np.clip(py, 0, cfg.height - 1))
        res = pick(self.scene, self.cpu, camera, px, py, cfg.width, cfg.height)
        with self.state.lock:
            self.state.pick_result = {
                "hit": res.hit, "tri": res.tri, "instance": res.instance,
                "instance_name": res.instance_name, "material": res.material,
                "t": res.t if res.t != float("inf") else -1.0,
                "position": list(res.position),
            }
            # toggle: picking the same instance again clears the outline
            self.state.picked_instance = (
                -1 if self.state.picked_instance == res.instance else res.instance
            )

    # -- editor manipulation (gizmo + material editor) ---------------------

    def _apply_transforms(self, reqs):
        """Accumulate per-instance TRS edits and refit the device scene.

        Each req: {"instance": i, "translate": [x,y,z]} and/or
        {"rotate_y": radians}, {"scale": s}. The composed rest->now
        transforms go through scene.refit.refit_scene (the TLAS-update
        analog); temporal state resets (history predates the edit).
        """
        from ..scene.refit import refit_scene
        from ..utils import log as L

        for req in reqs:
            i = int(req.get("instance", -1))
            if not (0 <= i < self._inst_xform.shape[0]):
                continue
            m = np.eye(4, dtype=np.float64)
            if "scale" in req:
                m[:3, :3] *= float(req["scale"])
            if "rotate_y" in req:
                a = float(req["rotate_y"])
                c, s = math.cos(a), math.sin(a)
                m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) @ m[:3, :3]
            if "translate" in req:
                m[:3, 3] = np.asarray(req["translate"], np.float64)
            cur = np.eye(4)
            cur[:3] = self._inst_xform[i]
            self._inst_xform[i] = (m @ cur)[:3].astype(np.float32)
            L.info(f"transform instance {i}: {req}")
        delta_pos = np.concatenate([self._inst_xform, np.eye(3, 4, dtype=np.float32)[None]], 0)
        lin = delta_pos[:, :, :3]
        delta_nrm = np.linalg.inv(lin.astype(np.float64)).transpose(0, 2, 1)
        self.scene = refit_scene(self._scene_rest, delta_pos, delta_nrm.astype(np.float32))
        self._frame_state = None

    _MAT_FIELDS = {
        "base_color": ("base_color", 3), "metallic": ("metallic", 1),
        "roughness": ("roughness", 1), "emissive": ("emissive", 3),
        "ior": ("ior", 1), "transmission": ("transmission", 1),
        "coat_weight": ("coat_weight", 1),
        "coat_roughness": ("coat_roughness", 1),
    }

    def materials_json(self):
        m = self.cpu.materials
        out = []
        for i in range(m.base_color.shape[0]):
            out.append({
                "index": i,
                "base_color": [round(float(v), 4) for v in m.base_color[i]],
                "metallic": round(float(m.metallic[i]), 4),
                "roughness": round(float(m.roughness[i]), 4),
                "emissive": [round(float(v), 4) for v in m.emissive[i]],
                "ior": round(float(m.ior[i]), 4),
                "transmission": round(float(m.transmission[i]), 4),
                "coat_weight": round(float(m.coat_weight[i]), 4),
                "coat_roughness": round(float(m.coat_roughness[i]), 4),
            })
        return out

    def _apply_materials(self, reqs):
        """Material editor edits: mutate the host material table and
        re-upload (the reference edits Material entries + re-uploads the
        MaterialBuffer, GuiPass material editor)."""
        from ..scene.scene import upload_scene
        from ..utils import log as L

        m = self.cpu.materials
        changed = False
        for req in reqs:
            i = int(req.get("index", -1))
            name = req.get("field")
            if name not in self._MAT_FIELDS or not (0 <= i < m.base_color.shape[0]):
                continue
            attr, width = self._MAT_FIELDS[name]
            val = req.get("value")
            arr = getattr(m, attr)
            if width == 1:
                arr[i] = float(val)
            else:
                arr[i] = np.asarray(val, np.float32)[:width]
            changed = True
            L.info(f"material {i}.{name} = {val}")
        if changed:
            self.scene = upload_scene(self.cpu, self.device)
            self._scene_rest = self.scene
            # re-apply any instance transforms on the fresh upload
            rest = np.tile(np.eye(3, 4, dtype=np.float32), (self._inst_xform.shape[0], 1, 1))
            if not np.allclose(self._inst_xform, rest):
                self._apply_transforms([])
            self._frame_state = None

    # -- main loop ---------------------------------------------------------

    def render_one(self, i):
        """Render frame ``i`` (frame seed ``app.frame_seed(i)``) and publish
        it. Returns the LDR image, [H, W, 3] uint8 numpy."""
        from ..app import RESTIR_MODES, frame_seed, with_outline
        from ..render.frame import render_frame, render_frame_restir
        from ..utils.params import registry
        from ..utils.png import encode_png
        from ..utils.stats import stats

        st = self.state
        with st.lock:
            dyaw, dpitch, ddolly = st.cam_delta
            st.cam_delta = [0.0, 0.0, 0.0]
            pick_req, st.pick_req = st.pick_req, None
            profile_req, st.profile_req = st.profile_req, False
            reload_req, st.reload_req = st.reload_req, False
            transform_req, st.transform_req = st.transform_req, []
            material_req, st.material_req = st.material_req, []
        if material_req:
            self._apply_materials(material_req)
        if transform_req:
            self._apply_transforms(transform_req)
        if reload_req:
            # dxc-shader-reload analog: re-import the op modules, swap in a
            # rebuilt kernel library, remake the configs from the reloaded
            # classes, reset temporal state (layouts may have changed)
            from .reload import rebuild, reload_ops

            done = reload_ops()
            self.cfg_holder[0] = rebuild(self.cfg_holder[0])
            self._frame_state = None
            with st.lock:
                st.reload_result = done
        if dyaw or dpitch or ddolly:
            self._apply_camera_delta(dyaw, dpitch, ddolly)
        registry.apply_pending()
        cfg = self.cfg_holder[0]
        cam = self._camera(i)
        if pick_req is not None:
            self._do_pick(pick_req[0], pick_req[1], cam)
        if profile_req:
            from ..profile import time_passes
            from ..utils import log as L

            try:
                times = time_passes(self.scene, cam, cfg, reps=5, textures=self.textures)
            except Exception as e:  # the frame loop keeps running; the page shows why
                L.error(f"time_passes failed: {e!r}")
                times = {"error": repr(e)}
            with st.lock:
                st.pass_times = times

        stats.begin_frame()
        restir = cfg.mode in RESTIR_MODES and self.scene.num_emissives > 0
        if restir:
            out, self._frame_state = render_frame_restir(
                self.scene, cam, frame_seed(i), cfg, self._frame_state, self.textures)
        else:
            out = render_frame(self.scene, cam, frame_seed(i), cfg)
        ldr = out["ldr"]
        picked = st.picked_instance
        if picked >= 0 and restir and self._frame_state is not None:
            ldr = with_outline(ldr, self._frame_state, picked)
        ldr = ldr.cpu().numpy()
        dt = stats.end_frame()
        st.publish(
            encode_png(ldr),
            {
                "frame_ms": dt * 1000.0, "fps": stats.fps, "frame": i,
                "mode": cfg.mode, "width": cfg.width, "height": cfg.height,
                "tris": self.cpu.num_tris,
                "emissives": len(self.cpu.emissive_tris),
                "eye": [round(float(v), 4) for v in self.eye],
                "history_ms": [round(t * 1000.0, 2) for t in stats._frame_times],
                "device": str(self.device),
            },
        )
        return ldr

    def run(self, frames=None):
        i = 0
        while self.state.running and (frames is None or i < frames):
            self.render_one(i)
            i += 1

    def run_in_thread(self, frames=None):
        t = threading.Thread(target=self.run, kwargs={"frames": frames}, daemon=True)
        t.start()
        return t

    def stop(self):
        self.state.running = False
