"""One frame function over either package: the port (``zetaray_tpu_torch``,
the system under test) or the benchmark's frozen plain copy of it
(``reference.portref``). Both have the same modules, so one adapter
builds the configuration, loads the scene and renders a frame with each.

A configuration with an ``animation`` block (``clip``, ``frame_dt_s``,
``loop``) plays its glTF clip as the port's app does each frame: frame k
shows clip time k * frame_dt_s, the uploaded rest pose is refit to it
(``scene.refit.refit_scene``), and the frame gets each instance's motion
from the pose one frame earlier. Every frame refits from the rest pose, so
a frame depends on its number and its input state alone."""

from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass
class Animated:
    """An animated configuration's scene: the package's upload of the rest
    pose and its ``AnimationRig`` over the clip."""

    rest: object
    rig: object
    dt: float  # clip seconds a frame
    loop: bool


class Port:
    def __init__(self, package: str, load_workers: int | None = None):
        """``load_workers``: the threads ``load_scene`` flattens the glTF on
        (None: the loader's default, as a user's call)."""
        imp = lambda m: importlib.import_module(f"{package}.{m}")
        self.package = package
        self.load_kw = {} if load_workers is None else {"workers": load_workers}
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

    def load(self, gltf_path, device, triangles: int | None = None,
             animation: dict | None = None):
        """The glTF scene, loaded and uploaded as a user's file is;
        ``triangles``: the count the file must hold; ``animation``: the
        configuration's block, which makes the scene ``Animated``."""
        if animation is None:
            cpu = self.scene_mod.load_scene(str(gltf_path), **self.load_kw)
        else:
            doc = self.module("scene.gltf").load_gltf(str(gltf_path))
            cpu = self.scene_mod.load_scene(doc, **self.load_kw)
        if triangles is not None and cpu.num_tris != triangles:
            raise ValueError(f"{gltf_path} holds {cpu.num_tris} triangles, not {triangles}")
        scene = self.scene_mod.upload_scene(cpu, device=device)
        if animation is None:
            return scene
        rig = self.module("scene.animation").AnimationRig(doc, int(animation["clip"]))
        if not rig.animated:
            raise ValueError(f"{gltf_path} has no clip {animation['clip']}")
        return Animated(scene, rig, float(animation["frame_dt_s"]), bool(animation["loop"]))

    def pose(self, scene: Animated, k: int):
        """(the rest pose refit to frame k's clip time, the frame's motion:
        each instance's transform from frame k's pose to frame k - 1's)."""
        t, rig, loop = k * scene.dt, scene.rig, scene.loop
        # looked up at call time, so that the tracer's wrapper of it runs
        posed = self.module("scene.refit").refit_scene(scene.rest, *rig.deltas(t, loop))
        worlds = lambda t: rig.instance_worlds(t, loop)
        motion, _ = self.module("scene.animation").transform_deltas(
            worlds(t), worlds(max(t - scene.dt, 0.0)))
        return posed, motion

    def camera(self, traffic, k: int):
        cam = self.camera_mod.Camera.look_at(traffic.eye(k), tuple(traffic.target),
                                             vfov_deg=traffic.vfov, aspect=traffic.aspect)
        return cam.with_jitter(k)

    def frame(self, scene, traffic, k: int, cfg, state):
        """Frame k of the traffic: (outputs, new state)."""
        if not isinstance(scene, Animated):
            return self.F.render_frame_restir(scene, self.camera(traffic, k),
                                              traffic.frame_seed(k), cfg, state)
        posed, motion = self.pose(scene, k)
        return self.F.render_frame_restir(posed, self.camera(traffic, k), traffic.frame_seed(k),
                                          cfg, state, motion=motion)

    def state_from(self, state):
        """Another package's ``FrameState`` as this package's: the same
        tensors, the camera rebuilt from its fields."""
        fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
        cam = fields["camera_prev"]
        fields["camera_prev"] = self.camera_mod.Camera(
            **{f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)})
        return self.F.FrameState(**fields)
