"""scene_upload_s: the seconds of the port's last ``upload_scene`` (the host
arrays to the device tables: clusters, trees, Woop rows), its span
``setup:upload_scene`` in the port's recorder
(``zetaray_tpu_torch.utils.stats``). None without it."""

import sys


def read(run):
    mod = sys.modules.get("zetaray_tpu_torch.utils.stats")
    return (getattr(getattr(mod, "stats", None), "setup", None) or {}).get("setup:upload_scene")
