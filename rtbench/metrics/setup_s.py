"""setup_s: process start to the window's start: imports, the kernels'
build (only a checkout's first run builds), the scene's write, load and
upload, and the warm frames."""


def read(run):
    return run.setup_s
