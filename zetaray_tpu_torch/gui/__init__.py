"""Interactive GUI/editor (the reference's GuiPass + imgui editor,
GuiPass.cpp:343-589, rebuilt as a dependency-free web app), as the JAX
package's ``gui/``.

The reference renders an ImGui dock over the swapchain with a param tree,
per-pass GPU timings, a frame-time graph, picking, and a render-graph
visualizer. A headless GPU host has no swapchain; the equivalent surface is
a local web page: ``python -m zetaray_tpu_torch.app scene.gltf --gui 8800`` serves
the live viewport (PNG stream), the full utils.params tree, frame stats,
pick-on-click with Sobel outline, camera orbit/dolly, and the frame DAG.

Modules:
  - viewer: the render loop + shared ViewerState (frames, picks, camera)
  - server: http.server endpoints (JSON API + PNG viewport)
  - page:   the single-page UI (embedded HTML/JS, no external assets)
  - reload: hot reload of the op modules and the kernels' library
"""

from .viewer import Viewer, ViewerState
from .server import make_server

__all__ = ["Viewer", "ViewerState", "make_server"]
