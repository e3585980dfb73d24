"""pull_ms.video: host milliseconds a frame in engine/wavefront.pull_packed
over the window, the video cell's frames (the device-to-host copy of the packed slabs and their
bytes written into the caller's buffer)."""

from gbench import readers


def read(run):
    return readers.span_ms_per_frame(run, "pull")
