"""pull_ms.mesh: host milliseconds a frame in engine/wavefront.pull_packed
over the window, the mesh cell's frames (the device-to-host copy of the packed slabs and their
bytes written into the caller's buffer)."""

from gbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "pull")
