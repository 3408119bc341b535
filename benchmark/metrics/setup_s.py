"""setup_s: from the start of the process to the end of the warm segment
(imports, mesh, the region with its cold initial solve, the start-up, the
snapshot and one segment; in a checkout's first run also the kernels'
nvcc builds)."""


def read(run):
    return run.setup_s
