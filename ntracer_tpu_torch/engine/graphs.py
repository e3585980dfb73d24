"""CUDA graphs of a frame's glue, replayed around the eager walk launches.

A composite frame on one card is a fixed chain: glue (the rays, the chunk
order and shared rows, shading, packing: hundreds of small torch ops), a
walk's launch, glue, another walk's launch (occlusion, bounce and
transparent walks), ..., glue that ends in the frame's output.  The host
takes longer to enqueue the glue than the card takes to run it, so the card
waits on Python.  ``frame`` captures each stretch of glue between two walk
launches once as a CUDA graph (a segment) and then runs a frame as: replay
segment 0, call walk 0's C entry, replay segment 1, and so on.

Capture.  The walk wrappers launch through ``launch``.  While this thread
captures a frame, ``launch`` does not call the C entry: it closes the
segment, records the entry and its arguments (device pointers of tensors
the record keeps alive) and opens the next segment.  A walk's own input
prep (scene exit, block liveness, visit boxes, output and scratch
allocations) is glue, so it lands in the segment before the launch and
the eager step is only the C call.  ``walk_span`` hands the replay the
span around each call (``dispatch.walk``, ``dispatch.occlusion``).  The
segments of a frame share one graph memory pool and replay in the order of
their capture.  Capture runs with ``capture_error_mode="thread_local"``, so
a ``CallbackRenderer``'s pull worker goes on copying earlier frames on its
own streams meanwhile.

Inputs and key.  The camera's origin and axes and the scene's ambient and
background colors are one static float32 input tensor, refreshed before
segment 0 by one non-blocking copy from pinned memory.  All else that the
glue bakes in (shapes, control flow, Python scalars) is in the frame's key
(``frame_key``).  A scene keeps the entries of at most ``MAX_KEYS`` keys
(``scene._torch_graphs``), all dropped when its ``_version`` changes.

Output.  After the last segment the frame's output (packed stream or float
colors) is cloned into an ordinary tensor, so frames in flight never share
a buffer.  The frame's counters (``wavefront.frame_stats``) are captured
ops on the segments' static tensors too, stacked in the last segment and
cloned after each replay.

When.  ``eligible``: a composite frame on one CUDA device, without
diagnostic masks, whose pool is neither split into prim shards across
devices nor traced by the chunk scan (which reads device values on the
host).  The first frame of a key runs eagerly: it warms up what a capture
must not do (the kernels' modules load, the C library builds).  The second
captures, then replays; later ones replay.  The counters
``glue_graph_replays`` and ``glue_graph_captures`` are 1 in a frame that
replayed and in one that captured.
"""

from __future__ import annotations

import collections
import threading

import torch

from .. import tracing

# the keys whose graphs a scene keeps
MAX_KEYS = 4
# the frame counters of this module (frame_stats, tracing)
COUNTERS = ("glue_graph_replays", "glue_graph_captures")

# a key whose first frame has run eagerly: its next frame captures
_WARM = "warm"

_local = threading.local()


def eligible(device, arrs, masks, scan):
    """Whether a composite frame on ``device`` over the device scene
    ``arrs`` runs from graphs: one CUDA device, no diagnostic ``masks``, a
    pool that is not split into prim shards over devices
    (``arrs["shards"]``) and does not take the chunk scan (``scan``:
    ``trace_scan`` and ``occlusion_scan`` read device values on the
    host)."""
    return (device.type == "cuda" and masks is None and "shards" not in arrs
            and not scan)


def frame_key(scene, cfg, device, width, height, key, fov, counters):
    """What a frame's graphs bake in: the scene's version (its device
    scene, materials, lights and config), the device, the frame's size,
    the format key (None: float colors), the render flags that
    ``wavefront.scene_config`` re-reads, the fov parameters and whether the
    frame counts (``counters``)."""
    return (scene._version, str(device), width, height, key, cfg.shadows,
            cfg.camera_light, cfg.max_reflect_depth, cfg.bg_axis, fov,
            bool(counters))


class _Call:
    """A walk's C launch between two segments."""

    __slots__ = ("entry", "args", "device", "keep", "then", "span")

    def __init__(self, entry, args, device, keep, then):
        self.entry = entry
        self.args = args
        self.device = device
        self.keep = keep
        self.then = then
        self.span = None

    def __call__(self):
        err = self.entry(*self.args, _stream(self.device))
        if self.then is not None:
            self.then(err)
        return err


class _Capture:
    """A frame's capture in progress on this thread: its segments, the
    walk calls between them, and the span of the walk being prepared."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = []
        self.calls = []
        self.span = None

    def open(self):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self.graphs.append(graph)

    def close(self):
        self.graphs[-1].capture_end()

    def cut(self, call):
        self.close()
        call.span, self.span = self.span, None
        self.calls.append(call)
        self.open()


class _Entry:
    """A key's graphs: the segments, the walk calls between them, the
    static inputs and output, the counters, and the frame body whose
    closure holds the device scene the graphs read."""

    __slots__ = ("graphs", "calls", "inputs", "out", "consts", "counted",
                 "counts", "body")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def launch(entry, args, device, keep=(), then=None):
    """Call a walk's C entry, ``entry(*args, stream)`` on ``device``'s
    current stream, then ``then(error code)``; returns the code.  While
    this thread captures a frame the call is recorded instead, between the
    segment it closes and the next one, and made (with ``then``) at each
    replay; ``keep`` holds the tensors whose pointers ``args`` carry, and
    0 is returned."""
    cap = getattr(_local, "capture", None)
    if cap is None:
        return _Call(entry, args, device, keep, then)()
    cap.cut(_Call(entry, args, device, keep, then))
    return 0


def walk_span(name, **attrs):
    """The span around a walk's wrapper (``tracing.span``).  While this
    thread captures a frame there is none: the capture gives the walk's
    replayed call the span ``name`` with ``attrs``."""
    cap = getattr(_local, "capture", None)
    if cap is None:
        return tracing.span(name, **attrs)
    cap.span = (name, attrs)
    return tracing.OFF


def _entries(scene):
    """The scene's entries by key; dropped when its version changed."""
    held = getattr(scene, "_torch_graphs", None)
    if held is None or held[0] != scene._version:
        held = (scene._version, collections.OrderedDict())
        scene._torch_graphs = held
    return held[1]


def _keep(entries, key, entry):
    entries[key] = entry
    entries.move_to_end(key)
    while len(entries) > MAX_KEYS:
        entries.popitem(last=False)


def frame(scene, key, device, host, body, stats):
    """A frame of ``scene`` under ``key`` (``frame_key``) from its graphs,
    or None when it is the first frame of the key, which the caller runs
    eagerly.  ``host`` is the frame's inputs, a float32 numpy vector;
    ``body(inputs, stats)`` enqueues the frame's work on the device tensor
    of ``host`` and returns its output, counting into the dict ``stats``
    (or nothing, None).  Returns a fresh tensor of the output."""
    entries = _entries(scene)
    entry = entries.get(key)
    if entry is None:
        _keep(entries, key, _WARM)
        return None
    captured = entry is _WARM
    if captured:
        with tracing.span("dispatch.capture"):
            entry = _capture(device, host, body, stats is not None)
    _keep(entries, key, entry)
    out = _replay(entry, host, stats)
    if stats is not None:
        stats.update(glue_graph_replays=1, glue_graph_captures=int(captured))
    return out


def _capture(device, host, body, counters):
    """Capture ``body``'s work on a side stream as segments cut at the
    walk launches; nothing runs."""
    e = _Entry()
    e.body = body
    e.inputs = torch.empty(host.shape, dtype=torch.float32, device=device)
    stats = {} if counters else None
    cap = _local.capture = _Capture()
    try:
        with torch.cuda.stream(torch.cuda.Stream(device)):
            cap.open()
            try:
                e.out = body(e.inputs, stats)
                stats = stats or {}
                e.consts = {k: v for k, v in stats.items()
                            if not isinstance(v, torch.Tensor)}
                e.counted = [k for k, v in stats.items()
                             if isinstance(v, torch.Tensor)]
                e.counts = torch.stack([stats[k].to(torch.int64)
                                        for k in e.counted]) \
                    if e.counted else None
            finally:
                cap.close()
    finally:
        _local.capture = None
    e.graphs, e.calls = cap.graphs, cap.calls
    return e


def _replay(e, host, stats):
    """Refresh the inputs, replay the segments with the walk calls between
    them, and clone the output and the counters."""
    with tracing.span("dispatch.camera"):
        src = torch.from_numpy(host)
        if e.inputs.is_cuda:
            src = src.pin_memory()
        e.inputs.copy_(src, non_blocking=True)
    for i, graph in enumerate(e.graphs):
        with tracing.span("dispatch.graph", seg=i):
            graph.replay()
        if i < len(e.calls):
            call = e.calls[i]
            name, attrs = call.span or (None, {})
            with tracing.span(name, **attrs) if name else tracing.OFF:
                call()
    if stats is not None:
        stats.update(e.consts)
        if e.counts is not None:
            stats.update(zip(e.counted, e.counts.clone()))
    return e.out.clone()
