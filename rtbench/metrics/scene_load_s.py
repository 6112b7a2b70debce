"""scene_load_s: the seconds of the port's last ``load_scene`` (the cell's
glTF file to the flattened host arrays), its span ``setup:load_scene`` in
the port's recorder (``zetaray_tpu_torch.utils.stats``). None without it."""

import sys


def read(run):
    mod = sys.modules.get("zetaray_tpu_torch.utils.stats")
    return (getattr(getattr(mod, "stats", None), "setup", None) or {}).get("setup:load_scene")
