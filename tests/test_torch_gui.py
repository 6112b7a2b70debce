"""The port's interactive viewer/editor (``zetaray_tpu_torch.gui``): every
endpoint of the JAX package's ``tests/test_gui.py``, on the CPU, on the
procedural animated box written as glTF.

The viewer renders the JAX app's default ReSTIR DI frame at 24^2 on the
CPU; the HTTP server serves on an ephemeral port of 127.0.0.1 from a
thread, every request has a time limit, and the fixture stops both. The
hot reload re-imports the op and render modules, which would leave the
other tests of this process with stale classes, so it runs in a fresh
interpreter (``test_hot_reload_then_frame``), which also drives the render
thread and /api/quit.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from zetaray_tpu_torch.gui import Viewer, make_server
from zetaray_tpu_torch.ops.pathtracer import PTConfig
from zetaray_tpu_torch.ops.post import TONEMAPPERS_P
from zetaray_tpu_torch.render.frame import RenderConfig
from zetaray_tpu_torch.render.graph import frame_dag
from zetaray_tpu_torch.scene.procedural import animated_box
from zetaray_tpu_torch.utils import log as L
from zetaray_tpu_torch.utils.params import registry

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SIZE = 24
TALL = (9, 15)  # a pixel on the tall block (instance 1, "tall_block")
OUTLINE_RGB = [255, 158, 25]  # post.picked_outline_p's colour, in u8


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.read(), dict(r.headers)


def _post(port, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(obj).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


@pytest.fixture(scope="module")
def gltf(tmp_path_factory):
    return animated_box(tmp_path_factory.mktemp("gui") / "box.gltf")


@pytest.fixture(scope="module")
def gui(gltf):
    registry._params.clear()  # params self-register
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="restir_di", pt=PTConfig(max_bounces=1))
    L.set_mirror(False)
    viewer = Viewer(str(gltf), cfg, textures=False, device="cpu")
    server = make_server(viewer, 0)
    port = server.server_address[1]
    srv_t = threading.Thread(target=server.serve_forever, daemon=True)
    srv_t.start()
    viewer.render_one(0)  # publish one frame synchronously
    try:
        yield viewer, port
    finally:
        viewer.stop()
        server.shutdown()
        server.server_close()
        srv_t.join(timeout=30)
        L.set_mirror(True)
        registry._params.clear()
    assert not srv_t.is_alive()


def _outlined(ldr):
    return int((ldr.reshape(-1, 3) == OUTLINE_RGB).all(1).sum())


def test_page_and_frame(gui):
    viewer, port = gui
    status, body, _ = _get(port, "/")
    assert status == 200 and b"zetaray_tpu_torch" in body
    status, png, headers = _get(port, "/frame.png")
    assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
    assert int(headers["X-Frame-Index"]) >= 1
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/no/such/page")
    assert e.value.code == 404


def test_params_roundtrip(gui):
    viewer, port = gui
    params = json.loads(_get(port, "/api/params")[1])
    paths = {p["path"] for p in params}
    assert "Renderer/General/Tonemapper" in paths and "PathTracer/Path/MaxBounces" in paths
    _post(port, "/api/set", {"path": "Renderer/General/Tonemapper", "value": "neutral"})
    viewer.render_one(1)
    assert viewer.cfg_holder[0].tonemapper == "neutral"
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/api/set", {"path": "No/Such/Param", "value": 1})
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/api/set", {"path": "Renderer/General/Tonemapper",
                                 "value": "no_such_tonemapper"})
    assert e.value.code == 400
    # a bad value queued directly must not kill the frame loop
    registry.queue_set("Renderer/General/Tonemapper", "also_bad")
    viewer.render_one(10)
    assert viewer.cfg_holder[0].tonemapper == "neutral"
    assert set(TONEMAPPERS_P) <= set(registry.get("Renderer/General/Tonemapper").choices)
    _post(port, "/api/set", {"path": "Renderer/General/Tonemapper", "value": "agx"})
    viewer.render_one(11)


def test_stats_and_graph(gui):
    viewer, port = gui
    s = json.loads(_get(port, "/api/stats")[1])
    assert s["width"] == SIZE and s["frame_index"] >= 1 and s["tris"] == 36
    assert s["mode"] == "restir_di" and s["device"] == "cpu"
    dot = json.loads(_get(port, "/api/graph")[1])["dot"]
    assert dot == frame_dag(viewer.cfg_holder[0])


def test_pick_and_outline(gui):
    viewer, port = gui
    viewer.state.picked_instance = -1
    before = viewer.render_one(2)
    assert _outlined(before) == 0
    _post(port, "/api/pick", {"x": TALL[0], "y": TALL[1]})
    outlined = viewer.render_one(3)  # the pick resolves at the frame boundary
    res = json.loads(_get(port, "/api/pick")[1])
    assert res["hit"] is True and res["instance"] == 1 and res["instance_name"] == "tall_block"
    assert res["t"] > 0 and len(res["position"]) == 3
    assert viewer.state.picked_instance == 1
    assert _outlined(outlined) > 0
    # the same instance again toggles the outline off
    _post(port, "/api/pick", {"x": TALL[0], "y": TALL[1]})
    assert _outlined(viewer.render_one(4)) == 0 and viewer.state.picked_instance == -1
    # a miss: the pixel clamps into the image, the pick reports no hit
    viewer.eye = np.asarray((0.0, 1.0, 60.0))
    viewer.target = np.asarray((0.0, 1.0, 120.0))
    _post(port, "/api/pick", {"x": 400, "y": -3})
    viewer.render_one(5)
    res = json.loads(_get(port, "/api/pick")[1])
    assert res["hit"] is False and res["tri"] == -1 and res["t"] == -1.0
    viewer.eye = np.asarray((0.0, 1.0, 3.5))
    viewer.target = np.asarray((0.0, 1.0, 0.0))
    viewer.state.picked_instance = -1


def test_camera_orbit(gui):
    viewer, port = gui
    eye0 = viewer.eye.copy()
    r0 = np.linalg.norm(eye0 - viewer.target)
    _post(port, "/api/camera", {"dyaw": 0.3, "ddolly": 0.2})
    viewer.render_one(6)
    assert not np.allclose(viewer.eye, eye0)
    assert np.linalg.norm(viewer.eye - viewer.target) > r0  # dollied out
    assert np.allclose(viewer.target, (0, 1.0, 0.0))  # orbit keeps the target
    viewer.eye = eye0


def test_profile_endpoint(gui):
    viewer, port = gui
    status, resp = _post(port, "/api/profile", {})
    assert resp["ok"] and viewer.state.profile_req is True
    viewer.render_one(7)  # runs time_passes (6 frames at 24^2) at the boundary
    times = json.loads(_get(port, "/api/pass_times")[1])
    assert "error" not in times
    assert times["reuse:DI RIS (B2)"] > 0.0 and "frame:G-buffer (B8)" in times


def test_material_editor_roundtrip(gui):
    viewer, port = gui
    st, r = _post(port, "/api/material", {"index": 0, "field": "roughness", "value": 0.33})
    assert st == 200 and r["queued"]
    viewer.render_one(101)  # applies the queued edit: a new upload
    mats = json.loads(_get(port, "/api/materials")[1])
    assert abs(mats[0]["roughness"] - 0.33) < 1e-6
    assert float(viewer.scene.mat_roughness[0]) == pytest.approx(0.33)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/api/material", {"index": 0, "field": "nope", "value": 1})
    assert e.value.code == 400


def test_transform_gizmo_moves_instance(gui):
    viewer, port = gui
    sel = viewer.scene.inst_id == 1
    x_before = float(viewer.scene.v0[sel, 0].mean())
    st, r = _post(port, "/api/transform", {"instance": 1, "translate": [0.25, 0.0, 0.0]})
    assert st == 200 and r["queued"]
    viewer.render_one(102)
    x_after = float(viewer.scene.v0[sel, 0].mean())
    assert abs((x_after - x_before) - 0.25) < 1e-5
    assert viewer._frame_state is not None  # the frame after the edit started a new chain
    _post(port, "/api/transform", {"instance": 1, "translate": [-0.25, 0, 0]})
    viewer.render_one(103)
    assert abs(float(viewer.scene.v0[sel, 0].mean()) - x_before) < 1e-5


def test_log_endpoint(gui):
    viewer, port = gui
    L.info("gui-test marker")
    entries = json.loads(_get(port, "/api/log")[1])["log"]
    assert any("gui-test marker" in e[2] for e in entries)


RELOAD_SCRIPT = textwrap.dedent('''
    import json, sys, threading, time, urllib.request
    import numpy as np, torch
    sys.modules["jax"] = None  # the viewer needs nothing of JAX
    from zetaray_tpu_torch.gui import Viewer, make_server
    from zetaray_tpu_torch.ops.pathtracer import PTConfig
    from zetaray_tpu_torch.render.frame import RenderConfig
    from zetaray_tpu_torch.utils import log

    log.set_mirror(False)
    def call(path, obj=None):
        req = urllib.request.Request("http://127.0.0.1:%d%s" % (port, path),
                                     data=None if obj is None else json.dumps(obj).encode(),
                                     method="GET" if obj is None else "POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read()) if path != "/frame.png" else r.read()
    cfg = RenderConfig(width=16, height=16, mode="restir_gi", pt=PTConfig(max_bounces=1))
    viewer = Viewer(sys.argv[1], cfg, device="cpu")
    server = make_server(viewer, 0)
    port = server.server_address[1]
    srv = threading.Thread(target=server.serve_forever, daemon=True)
    srv.start()
    viewer._frame_state = None
    before = viewer.render_one(20)
    viewer._frame_state = object()  # must be cleared by the reload
    assert call("/api/reload", {})["ok"]
    cls = type(viewer.cfg_holder[0])
    after = viewer.render_one(20)
    reloaded = call("/api/reload_result")["reloaded"]
    import zetaray_tpu_torch.render.frame as F
    out = dict(reloaded=reloaded, equal=bool(np.array_equal(before, after)),
               new_cfg_class=type(viewer.cfg_holder[0]) is F.RenderConfig and cls is not F.RenderConfig)
    # the render thread, then /api/quit stops it and the server
    rt = viewer.run_in_thread()
    t0 = time.time()
    while viewer.state.frame_index < 4 and time.time() - t0 < 60:
        time.sleep(0.05)
    out["frames"] = viewer.state.frame_index
    assert call("/api/quit", {})["ok"]
    rt.join(timeout=60)
    srv.join(timeout=60)
    server.server_close()
    out["stopped"] = not rt.is_alive() and not srv.is_alive()
    print(json.dumps(out))
''')


def test_hot_reload_then_frame(gltf, tmp_path):
    """POST /api/reload re-imports the op and render modules at the next
    frame boundary, remakes the config from the reloaded classes and
    resets the temporal state: the next frame equals the frame before it
    (nothing changed on disk). Then the render thread runs and POST
    /api/quit stops it and the server."""
    script = tmp_path / "reload_run.py"
    script.write_text(RELOAD_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), *filter(None, [os.environ.get("PYTHONPATH")])]))
    p = subprocess.run([sys.executable, str(script), str(gltf)], capture_output=True,
                       text=True, timeout=240, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert "zetaray_tpu_torch.render.frame" in out["reloaded"]
    assert "zetaray_tpu_torch.ops.shading_soa" in out["reloaded"]
    assert "zetaray_tpu_torch.native" not in out["reloaded"]  # no kernel library to swap
    assert out["equal"] and out["new_cfg_class"]
    assert out["frames"] >= 4 and out["stopped"]
