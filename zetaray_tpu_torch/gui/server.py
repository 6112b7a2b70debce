"""HTTP surface of the GUI (dependency-free: http.server + json), as the JAX
package's ``gui/server.py``.

Endpoints (the JSON API the embedded page consumes; also usable headless
with curl, which is how the tests drive it):

  GET  /               the single-page UI (gui.page)
  GET  /frame.png      latest viewport frame (X-Frame-Index header)
  GET  /api/params     the full utils.params registry
  POST /api/set        {"path": ..., "value": ...} -> queued for next frame
  GET  /api/stats      frame time/fps/history + scene info
  GET  /api/pass_times per-pass ms (filled after POST /api/profile)
  POST /api/profile    request a profile.time_passes run
  POST /api/pick       {"x": px, "y": py} -> PickResult; outlines the pick
  GET  /api/pick       last pick result
  POST /api/camera     {"dyaw", "dpitch", "ddolly"} orbit/dolly deltas
  GET  /api/graph      {"dot": frame DAG in Graphviz DOT}
  GET  /api/materials  the material table (editor view)
  POST /api/material   {"index", "field", "value"} -> edit + re-upload
  POST /api/transform  {"instance", "translate"/[x,y,z] | "rotate_y" |
                        "scale"} -> gizmo edit, applied via scene refit
  GET  /api/log        {"log": [[level, msg], ...]} ring buffer
  POST /api/quit       stop the render loop + server

The manipulation tier mirrors the reference's GuiPass: ImGuizmo transform
gizmo + material editor + log window (GuiPass.cpp:343-589).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .viewer import Viewer


def make_server(viewer: Viewer, port: int = 0) -> ThreadingHTTPServer:
    """Bind (not serve) the GUI server; .server_address[1] is the port."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json", headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode())

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            st = viewer.state
            if self.path == "/" or self.path.startswith("/index"):
                from .page import PAGE

                self._send(200, PAGE.encode(), "text/html; charset=utf-8")
            elif self.path.startswith("/frame.png"):
                with st.lock:
                    png, idx = st.png, st.frame_index
                if not png:
                    self._json({"error": "no frame yet"}, 503)
                else:
                    self._send(200, png, "image/png",
                               headers=[("X-Frame-Index", str(idx))])
            elif self.path == "/api/params":
                from ..utils.params import registry

                self._json([
                    {
                        "path": p.path, "group": p.group,
                        "subgroup": p.subgroup, "name": p.name,
                        "kind": p.kind, "value": p.value, "min": p.min,
                        "max": p.max, "step": p.step,
                        "choices": list(p.choices),
                    }
                    for p in registry.all()
                ])
            elif self.path == "/api/stats":
                with st.lock:
                    self._json(dict(st.stats, frame_index=st.frame_index))
            elif self.path == "/api/pass_times":
                with st.lock:
                    self._json(st.pass_times)
            elif self.path == "/api/pick":
                with st.lock:
                    self._json(st.pick_result or {})
            elif self.path == "/api/reload_result":
                with st.lock:
                    self._json({"reloaded": list(st.reload_result)})
            elif self.path == "/api/graph":
                from ..render.graph import frame_dag

                self._json({"dot": frame_dag(viewer.cfg_holder[0])})
            elif self.path == "/api/materials":
                self._json(viewer.materials_json())
            elif self.path == "/api/log":
                from ..utils import log as L

                self._json({"log": L.ring()})
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            st = viewer.state
            try:
                req = self._body()
            except Exception as e:
                self._json({"error": f"bad json: {e}"}, 400)
                return
            if self.path == "/api/set":
                from ..utils.params import _validate, registry

                try:
                    p = registry.get(req["path"])  # exists?
                    _validate(p, req["value"])  # value acceptable?
                except KeyError:
                    self._json({"error": f"unknown param {req.get('path')}"}, 404)
                    return
                except (ValueError, TypeError) as e:
                    self._json({"error": str(e)}, 400)
                    return
                registry.queue_set(req["path"], req["value"])
                self._json({"ok": True})
            elif self.path == "/api/pick":
                with st.lock:
                    st.pick_req = (int(req["x"]), int(req["y"]))
                self._json({"ok": True, "queued": True})
            elif self.path == "/api/camera":
                with st.lock:
                    st.cam_delta[0] += float(req.get("dyaw", 0.0))
                    st.cam_delta[1] += float(req.get("dpitch", 0.0))
                    st.cam_delta[2] += float(req.get("ddolly", 0.0))
                self._json({"ok": True})
            elif self.path == "/api/profile":
                with st.lock:
                    st.profile_req = True
                self._json({"ok": True, "note": "poll /api/pass_times"})
            elif self.path == "/api/material":
                if req.get("field") not in viewer._MAT_FIELDS:
                    self._json({"error": f"unknown field {req.get('field')}"}, 400)
                    return
                with st.lock:
                    st.material_req.append(req)
                self._json({"ok": True, "queued": True})
            elif self.path == "/api/transform":
                with st.lock:
                    st.transform_req.append(req)
                self._json({"ok": True, "queued": True})
            elif self.path == "/api/reload":
                # hot reload (the reference's per-pass dxc reload button)
                with st.lock:
                    st.reload_req = True
                self._json({"ok": True, "note": "reloads at next frame; "
                                                "GET /api/reload_result"})
            elif self.path == "/api/quit":
                viewer.stop()
                self._json({"ok": True})
                threading.Thread(target=server.shutdown, daemon=True).start()
            else:
                self._json({"error": "not found"}, 404)

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    return server
