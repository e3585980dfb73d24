"""dispatch_ms.mesh: host milliseconds a frame in
engine/wavefront.dispatch_packed over the window (the mesh cell's frames)."""

from gbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "dispatch")
