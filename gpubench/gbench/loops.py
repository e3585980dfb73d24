# Frozen copy of the renderer loops of scripts/polytope.py (--benchmark, --output) and scripts/hypercube.py (benchmark) as of commit 5a3cfa5.
"""The one traffic generator: a renderer loop over a camera path, as a
traffic file describes it.

``renderer`` is ``"blocking"`` (``BlockingRenderer().render`` frame after
frame, the host clock around each call, the camera step outside it: the
loop of scripts/hypercube.py's benchmark and of scripts/polytope.py
--output) or ``"callback"`` (``CallbackRenderer().begin_render`` into
``depth`` buffers behind a semaphore, the next frame begun as soon as a
buffer is free: the loop of scripts/polytope.py --benchmark).  Both run
until a deadline or for a number of frames and record, a frame, when it
began and when its bytes were in the buffer.  The bytes of the frames in
``keep`` are copied out as they complete.
"""

from __future__ import annotations

import threading
import time

clock = time.perf_counter


class Spans:
    """Host spans by name: (start, end) pairs on ``clock``, kept only while
    ``on`` (the traced run)."""

    def __init__(self, on=False):
        self.on = on
        self.spans = {}
        self._wrapped = []

    def add(self, name, t0, t1):
        if self.on:
            self.spans.setdefault(name, []).append((t0, t1))

    def wrap(self, module, attr, name):
        """Record a span around every call of ``module.attr``."""
        inner = getattr(module, attr)

        def wrapped(*args, **kwargs):
            t0 = clock()
            try:
                return inner(*args, **kwargs)
            finally:
                self.add(name, t0, clock())

        self._wrapped.append((module, attr, inner))
        setattr(module, attr, wrapped)

    def unwrap(self):
        for module, attr, inner in reversed(self._wrapped):
            setattr(module, attr, inner)
        self._wrapped = []


class Loop:
    """One renderer loop: ``scene``, its renderer, ``cameras`` (one camera a
    step of the path) and the frame's buffers."""

    def __init__(self, traffic, scene, cameras, start, fmt, device, spans):
        import ntracer_tpu_torch as ntt
        self.scene = scene
        self.cameras = cameras
        self.start = start
        self.fmt = fmt
        self.spans = spans
        self.blocking = traffic["renderer"] == "blocking"
        depth = 1 if self.blocking else int(traffic["depth"])
        self.bufs = [bytearray(fmt.pitch * fmt.height) for _ in range(depth)]
        self.buf_frame = [None] * depth
        if self.blocking:
            self.renderer = ntt.BlockingRenderer(device=device)
        else:
            self.renderer = ntt.CallbackRenderer(device=device)
        self.kept = {}
        self.failed = 0

    def step(self, k):
        """Point the scene's camera at step ``k`` of the path."""
        t0 = clock()
        cams = self.cameras
        self.scene.set_camera(cams[(self.start + k) % len(cams)])
        self.spans.add("camera", t0, clock())

    def run(self, first, deadline=None, count=None, keep=()):
        """Frames ``first``, ``first + 1``, ... until ``deadline`` (on
        ``clock``) or for ``count`` frames.  Returns (frame, began, done)
        records in frame order; ``done`` is None for a frame whose bytes
        never came."""
        keep = set(keep)
        if self.blocking:
            return self._blocking(first, deadline, count, keep)
        return self._callback(first, deadline, count, keep)

    def _more(self, k, first, deadline, count):
        if count is not None:
            return k < first + count
        return clock() < deadline

    def _blocking(self, first, deadline, count, keep):
        recs = []
        k = first
        buf = self.bufs[0]
        while self._more(k, first, deadline, count):
            self.step(k)
            t0 = clock()
            ok = self.renderer.render(buf, self.fmt, self.scene)
            t1 = clock()
            self.buf_frame[0] = k
            if not ok:
                self.failed += 1
            recs.append((k, t0, t1 if ok else None))
            if k in keep:
                self.kept[k] = bytes(buf)
            k += 1
        return recs

    def _callback(self, first, deadline, count, keep):
        depth = len(self.bufs)
        free = threading.Semaphore(depth)
        lock = threading.Lock()
        done = {}
        begun = []
        called = threading.Condition(lock)

        def callback(_renderer):
            t = clock()
            with lock:
                k = first + len(done)
                done[k] = t
                slot = k % depth
                self.buf_frame[slot] = k
                if k in keep:
                    self.kept[k] = bytes(self.bufs[slot])
                called.notify_all()
            free.release()

        k = first
        self.step(k)
        while self._more(k, first, deadline, count):
            t0 = clock()
            if not free.acquire(timeout=600):
                raise SystemExit("the render queue stalled: no callback "
                                 "came for 600 s")
            self.spans.add("wait", t0, clock())
            if count is None and clock() >= deadline:
                free.release()
                break
            t1 = clock()
            self.renderer.begin_render(self.bufs[k % depth], self.fmt,
                                       self.scene, callback)
            begun.append((k, t1))
            k += 1
            self.step(k)
        # every frame begun is due: wait for the last, a minute at most
        limit = clock() + 60
        with lock:
            while len(done) < len(begun) and clock() < limit:
                called.wait(timeout=1)
        recs = [(j, t, done.get(j)) for j, t in begun]
        self.failed += sum(1 for r in recs if r[2] is None)
        return recs

    def buffers(self):
        """(frame, bytes) of every buffer that holds a frame."""
        return [(k, bytes(b)) for k, b in zip(self.buf_frame, self.bufs)
                if k is not None]
