"""Faults planted in the timed path underneath a run, for the tests that
show ``correct`` can fail.  Each maker takes pytest's ``monkeypatch`` and
returns the ``fault(wavefront)`` that ``cell.run_cell`` installs before
the renderer is made."""


def unchanged(monkeypatch):
    """Every frame after the first leaves the buffer as it was."""
    def fault(wf):
        inner = wf.pull_packed
        calls = []

        def pull(slabs, fmt, view, abort):
            calls.append(1)
            return inner(slabs, fmt, view, abort) if len(calls) == 1 \
                else True
        monkeypatch.setattr(wf, "pull_packed", pull)
    return fault


def stale(monkeypatch):
    """Every frame leaves the bytes of the frame pulled before it in the
    buffer (the first frame: zeros)."""
    def fault(wf):
        inner = wf.pull_packed
        prev = []

        def pull(slabs, fmt, view, abort):
            ok = inner(slabs, fmt, view, abort)
            now = bytes(view)
            view[:len(now)] = prev.pop() if prev else bytes(len(now))
            prev.append(now)
            return ok
        monkeypatch.setattr(wf, "pull_packed", pull)
    return fault


def half(monkeypatch):
    """Half of each frame's pixels left out of the buffer."""
    def fault(wf):
        inner = wf._write_pixels

        def write(view, fmt, data, start_px, total):
            return inner(view, fmt, data[:(total - start_px) // 2],
                         start_px, total)
        monkeypatch.setattr(wf, "_write_pixels", write)
    return fault


def altered(monkeypatch):
    """A bit of one pixel in sixteen flipped where the bytes are packed."""
    def fault(wf):
        inner = wf.packing.pack_device_stream

        def pack(*args, **kwargs):
            out = inner(*args, **kwargs).clone()
            out[::4, 0] ^= 0x40
            return out
        monkeypatch.setattr(wf.packing, "pack_device_stream", pack)
    return fault


FAULTS = (unchanged, stale, half, altered)
