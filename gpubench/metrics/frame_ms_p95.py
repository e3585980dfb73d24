"""frame_ms_p95: the 95th percentile of the host clock around each
render() call, over every frame finished in the window (the camera step
outside it; the mesh cell)."""

from gbench import readers


def read(run):
    return readers.p95_ms(run)
