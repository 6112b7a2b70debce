"""One frame function over either package: the port (``zetaray_tpu_torch``,
the system under test) or the benchmark's frozen plain copy of it
(``reference.portref``). Both have the same modules, so one adapter
builds the configuration, loads the scene and renders a frame with each."""

from __future__ import annotations

import dataclasses
import importlib


class Port:
    def __init__(self, package: str):
        imp = lambda m: importlib.import_module(f"{package}.{m}")
        self.package = package
        self.F = imp("render.frame")
        self.scene_mod = imp("scene.scene")
        self.camera_mod = imp("scene.camera")
        self.cfg_classes = {
            "pt": imp("ops.pathtracer").PTConfig,
            "restir": imp("ops.restir_di").ReSTIRConfig,
            "restir_gi": imp("ops.restir_gi").ReSTIRGIConfig,
            "restir_pt": imp("ops.restir_pt").ReSTIRPTConfig,
            "upscale_cfg": imp("ops.upscale").UpscaleConfig,
        }

    def module(self, name: str):
        """The package's module ``name`` (``ops.restir_di``)."""
        return importlib.import_module(f"{self.package}.{name}")

    def render_config(self, render: dict, width: int, height: int):
        """``RenderConfig`` of a configuration's ``render`` settings at the
        traffic's display size; nested settings become their config classes."""
        kw = {k: (self.cfg_classes[k](**v) if k in self.cfg_classes else v)
              for k, v in render.items()}
        return self.F.RenderConfig(width=width, height=height, **kw)

    def load(self, gltf_path, device, triangles: int | None = None):
        """The glTF scene, loaded and uploaded as a user's file is;
        ``triangles``: the count the file must hold."""
        cpu = self.scene_mod.load_scene(str(gltf_path))
        if triangles is not None and cpu.num_tris != triangles:
            raise ValueError(f"{gltf_path} holds {cpu.num_tris} triangles, not {triangles}")
        return self.scene_mod.upload_scene(cpu, device=device)

    def camera(self, traffic, k: int):
        cam = self.camera_mod.Camera.look_at(traffic.eye(k), tuple(traffic.target),
                                             vfov_deg=traffic.vfov, aspect=traffic.aspect)
        return cam.with_jitter(k)

    def frame(self, scene, traffic, k: int, cfg, state):
        """Frame k of the traffic: (outputs, new state)."""
        return self.F.render_frame_restir(scene, self.camera(traffic, k), traffic.frame_seed(k),
                                          cfg, state)

    def state_from(self, state):
        """Another package's ``FrameState`` as this package's: the same
        tensors, the camera rebuilt from its fields."""
        fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
        cam = fields["camera_prev"]
        fields["camera_prev"] = self.camera_mod.Camera(
            **{f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)})
        return self.F.FrameState(**fields)
