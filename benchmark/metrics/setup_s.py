"""setup_s: from the harness's first line to the window's start (host
clock): imports, the CUDA context, loading the kernels (building them in a
checkout's first run), the pool built on the card and two warm-up calls."""


def read(run):
    return run.setup.get("setup_s")
