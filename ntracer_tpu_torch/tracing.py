"""Host spans and per-frame counters of the port, recorded where the work
happens; off by default.

    from ntracer_tpu_torch import tracing
    tracing.enable()
    ...render frames...
    records = tracing.drain()    # {"spans": [...], "counters": {...}}
    tracing.disable()

A span is one interval of host work: ``with tracing.span(name, **attrs):``.
It records its name, start and end (``time.perf_counter_ns``), its id, the
id of the span it was opened in on the same thread (a thread's open spans
form a stack), the thread and the frame.  The frame id is given to a span
(``frame=``) or taken from its parent; ``wavefront.dispatch_packed`` draws
a new one for each frame (``new_frame``) and gives it to the open spans
around it that have none (the renderer's ``frame.render`` or
``frame.begin``).  The frame's slabs carry the id to its pull, on whatever
thread runs it.  A span that starts on one thread and ends on another (a
frame waiting in ``CallbackRenderer``'s queue) is recorded whole by
``record``.

The per-frame counters are ``wavefront.frame_stats``'s: while tracing is on,
``wavefront._frame`` counts into a fresh dict that the recorder keeps under
the frame id (``frame_counters``).  Its values stay on the device until
``drain`` turns them into ints.  They include ``glue_graph_replays`` and
``glue_graph_captures``, 1 in a frame that replayed its glue from CUDA
graphs and in one that captured them (``engine/graphs.py``).

A frame replayed from its graphs has, under ``frame.dispatch``, the spans
``dispatch.camera``, one ``dispatch.graph`` a segment (``seg``) and between
them the walks' ``dispatch.walk`` and ``dispatch.occlusion`` (``walk``:
``"stream"``, ``"grid"`` or ``"scan"``, the kind of walk); the glue's
spans (``dispatch.primary_ctx``, ``dispatch.raygen``, ``dispatch.shade``,
``dispatch.pack``) appear only in eager frames and, inside
``dispatch.capture``, in the frame that captures.

Off, ``span`` returns one shared object that does nothing (no clock is
read, nothing is kept), ``now`` and ``new_frame`` return None and
``frame_counters`` returns None, so a frame counts nothing.
"""

from __future__ import annotations

import itertools
import threading
import time

clock = time.perf_counter_ns


class _Off:
    """The span of a disabled recorder."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Span:
    """One span of host work; a context manager on the thread that opens
    it."""

    __slots__ = ("rec", "name", "id", "parent", "thread", "frame", "attrs",
                 "start", "end", "_stack")

    def __init__(self, rec, name, frame, attrs):
        self.rec = rec
        self.name = name
        self.id = next(rec.ids)
        self.frame = frame
        self.attrs = attrs
        self.parent = None
        self.thread = None
        self.start = self.end = None

    def __enter__(self):
        stack = self._stack = self.rec.stack()
        if stack:
            self.parent = stack[-1].id
            if self.frame is None:
                self.frame = stack[-1].frame
            else:
                # the frame begins inside spans that wait for its id
                for s in reversed(stack):
                    if s.frame is not None:
                        break
                    s.frame = self.frame
        self.thread = threading.get_ident()
        stack.append(self)
        self.start = clock()
        return self

    def __exit__(self, *exc):
        self.end = clock()
        self._stack.pop()
        self.rec.keep(self)
        return False

    def record(self):
        return dict(name=self.name, start=self.start, end=self.end,
                    id=self.id, parent=self.parent, thread=self.thread,
                    frame=self.frame, attrs=self.attrs)


class Recorder:
    """The spans and per-frame counters recorded since the last drain."""

    def __init__(self):
        self.on = False
        self.ids = itertools.count(1)
        self.frames = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._spans = []
        self._counters = {}

    def stack(self):
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def keep(self, rec):
        with self._lock:
            self._spans.append(rec)

    def current_frame(self):
        stack = self.stack()
        return stack[-1].frame if stack else None

    def drain(self):
        with self._lock:
            spans, counters = self._spans, self._counters
            self._spans, self._counters = [], {}
        return dict(spans=[s.record() for s in spans], counters={
            frame: {k: int(v) for k, v in stats.items()}
            for frame, stats in counters.items()})


_rec = Recorder()


def enable():
    """Record spans and counters from now on."""
    _rec.on = True


def disable():
    """Record nothing more; what was recorded stays until ``drain``."""
    _rec.on = False


def enabled():
    return _rec.on


def span(name, frame=None, **attrs):
    """A span named ``name`` around the ``with`` block (``OFF`` while
    tracing is off).  ``frame`` gives the span a frame id; by default it
    takes its parent's."""
    if not _rec.on:
        return OFF
    return Span(_rec, name, frame, attrs)


def now():
    """The clock of the spans, or None while tracing is off."""
    return clock() if _rec.on else None


def record(name, start, frame=None, **attrs):
    """Record a span ``name`` from ``start`` (a ``now()``) to now, with no
    parent: a span that began on another thread.  Nothing when tracing is
    off or was off at ``start``."""
    if _rec.on and start is not None:
        sp = Span(_rec, name, frame, attrs)
        sp.start, sp.end = start, clock()
        sp.thread = threading.get_ident()
        _rec.keep(sp)


def new_frame():
    """A new frame id (None while tracing is off)."""
    return next(_rec.frames) if _rec.on else None


def frame_counters():
    """A fresh counter dict for the frame of the calling thread's open
    span, kept under its id; None while tracing is off or outside a
    frame."""
    if not _rec.on:
        return None
    frame = _rec.current_frame()
    if frame is None:
        return None
    stats = {}
    with _rec._lock:
        _rec._counters[frame] = stats
    return stats


def drain():
    """The records since the last drain, and clear them: ``spans``, a list
    of dicts (``name``, ``start`` and ``end`` in ``time.perf_counter_ns``,
    ``id``, ``parent``, ``thread``, ``frame``, ``attrs``) in the order they
    ended, and ``counters``, {frame id: {counter: int}}."""
    return _rec.drain()
