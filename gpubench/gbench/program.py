"""The program's own spans and counters in a run: what they say per frame,
and how a run collects them.

The port records host spans and per-frame counters where the work happens
(``ntracer_tpu_torch.tracing``: ``enable``, ``drain``).  A run's records are
``run["program"]``, one ``drain()`` after the run: spans as dicts with
``name``, ``start`` and ``end`` in ``time.perf_counter_ns`` (the harness's
clock, ``loops.clock``, in nanoseconds), ``id``, ``parent``, ``thread``,
``frame`` and ``attrs``, and ``counters`` {frame: {counter: int}}
(``wavefront.frame_stats``' keys).  No program span enters the profiler:
spans go onto the device trace's timeline by the offset ``trace.profile``
returns, as the harness's own do.

A frame belongs to the window when its ``frame.dispatch`` began in it, to
the traced frames when it began inside the profiled window.  Per frame
means summed by frame id over those frames, divided by their number.

``run_cell`` runs a cell with the program's tracing on and returns its
``run`` with the records beside the result.
"""

from __future__ import annotations

import time

from . import trace

NS = 1e-9
# the walks' spans; the rest of a frame's dispatch is its glue
WALKS = ("dispatch.walk", "dispatch.occlusion")
# the spans of the set-up each setup metric reads
SETUP = {"load_obj_s": "scene.load_obj", "kd_build_s": "scene.kd_build",
         "device_scene_s": "scene.device"}


def spans(run, name=None):
    sp = run.get("program", {}).get("spans", ())
    return [s for s in sp if name is None or s["name"] == name]


def setup_s(run, name):
    """Seconds in the spans ``name`` that ended before the window opened,
    summed; None when there is none."""
    t = [s["end"] - s["start"] for s in spans(run, name)
         if s["end"] * NS <= run["t_w0"]]
    return NS * sum(t) if t else None


def _frames_began(run, lo, hi):
    return sorted(s["frame"] for s in spans(run, "frame.dispatch")
                  if lo <= s["start"] * NS < hi)


def window_frames(run):
    """Ids of the frames dispatched in the window."""
    return _frames_began(run, run["t_w0"], run["t_w1"])


def traced_frames(run):
    """Ids of the frames dispatched inside the profiled window."""
    tr = run.get("traced")
    if not tr:
        return []
    return _frames_began(run, tr["offset"], tr["offset"] + tr["window_s"])


def _outermost(run, names, frames):
    """The spans ``names`` of ``frames`` that lie in no other such span."""
    by_id = {s["id"]: s for s in spans(run)}
    frames = set(frames)
    out = []
    for s in spans(run):
        if s["name"] not in names or s["frame"] not in frames:
            continue
        p = by_id.get(s["parent"])
        while p is not None and p["name"] not in names:
            p = by_id.get(p["parent"])
        if p is None:
            out.append(s)
    return out


def ms_per_frame(run, names, frames=None):
    """Host milliseconds a window frame in the spans ``names`` (outermost
    ones, so a span inside another of them counts once); None without
    frames or spans."""
    frames = window_frames(run) if frames is None else frames
    sp = _outermost(run, names, frames)
    if not frames or not sp:
        return None
    return 1e3 * NS * sum(s["end"] - s["start"] for s in sp) / len(frames)


def glue_ms(run):
    """Host milliseconds a window frame in ``frame.dispatch`` outside its
    walks (``dispatch.walk``, ``dispatch.occlusion``)."""
    frames = window_frames(run)
    total = ms_per_frame(run, ("frame.dispatch",), frames)
    if total is None:
        return None
    return total - (ms_per_frame(run, WALKS, frames) or 0.0)


def walk_visits(run):
    """The counter ``chunks_visited`` a window frame (the walks' chunk
    visits); None when no window frame counted."""
    counters = run.get("program", {}).get("counters", {})
    got = [counters[f]["chunks_visited"] for f in window_frames(run)
           if "chunks_visited" in counters.get(f, {})]
    return sum(got) / len(got) if got else None


def _minus(a, b, cuts):
    """[a, b) without the sorted intervals ``cuts``."""
    out = []
    for c0, c1 in cuts:
        if c1 <= a or c0 >= b:
            continue
        if c0 > a:
            out.append((a, c0))
        a = max(a, c1)
    if b > a:
        out.append((a, b))
    return out


def glue_intervals(run, frames):
    """The host intervals of ``frames``' glue on the trace's timeline
    (seconds from the profiled window's start): each ``frame.dispatch``
    without its walks."""
    off = run["traced"]["offset"]
    walks = sorted((s["start"] * NS - off, s["end"] * NS - off)
                   for s in _outermost(run, WALKS, frames))
    return [iv for s in spans(run, "frame.dispatch") if s["frame"] in frames
            for iv in _minus(s["start"] * NS - off, s["end"] * NS - off,
                             walks)]


def _overlap(xs, ys):
    """Total length of the intersection of two lists of disjoint
    intervals."""
    xs, ys = sorted(xs), sorted(ys)
    i = j = 0
    tot = 0.0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        if hi > lo:
            tot += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_glue_pct(run):
    """The share of the profiled window, in percent, in which the card was
    idle while the host was in the traced frames' glue; None without device
    operations or traced frames."""
    tr = run.get("traced")
    frames = traced_frames(run)
    if not tr or not tr["ops"] or not frames:
        return None
    idle = trace.gaps(tr["ops"], tr["window_s"])
    glue = glue_intervals(run, set(frames))
    return 100.0 * _overlap(idle, glue) / tr["window_s"]


def innermost(run, frames):
    """The profiled window cut where the traced frames' spans begin and
    end: [(t0, t1, name)] on the trace's timeline, ``name`` the deepest
    span open on any thread over [t0, t1) (the latest begun among equals),
    None where none is open."""
    off = run["traced"]["offset"]
    by_id = {s["id"]: s for s in spans(run)}

    def depth(s):
        n = 0
        while s["parent"] in by_id:
            s = by_id[s["parent"]]
            n += 1
        return n

    sp = [(s["start"] * NS - off, s["end"] * NS - off, depth(s), s["name"])
          for s in spans(run) if s["frame"] in frames]
    cuts = sorted({t for s in sp for t in s[:2]})
    out = []
    for t0, t1 in zip(cuts, cuts[1:]):
        open_ = [s for s in sp if s[0] <= t0 and s[1] >= t1]
        name = max(open_, key=lambda s: (s[2], s[0]))[3] if open_ else None
        out.append((t0, t1, name))
    return out


def idle_by_span(run):
    """Idle seconds of the profiled window by the program's innermost span
    (``innermost``) over the traced frames, largest first; ``"none"`` where
    no span of theirs was open."""
    tr = run.get("traced")
    frames = set(traced_frames(run))
    if not tr or not tr["ops"] or not frames:
        return []
    segs = innermost(run, frames)
    idle = trace.gaps(tr["ops"], tr["window_s"])
    tot = {}
    covered = 0.0
    j = 0
    for t0, t1, name in segs:
        while j < len(idle) and idle[j][1] <= t0:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < t1 and name is not None:
            s = min(t1, idle[k][1]) - max(t0, idle[k][0])
            if s > 1e-9:        # no sliver of float rounding
                tot[name] = tot.get(name, 0.0) + s
                covered += s
            k += 1
    rest = sum(b - a for a, b in idle) - covered
    if rest > 0:
        tot["none"] = rest
    return sorted(tot.items(), key=lambda kv: -kv[1])


def note(run):
    """One line: the traced frames' idle seconds by the program's innermost
    span."""
    return "idle s of the traced frames by the program's innermost span: " \
        + ", ".join(f"{k} {v:.6f}" for k, v in idle_by_span(run))


def read(run, suffix):
    """Every metric the program's records give, by name (``suffix``, the
    cell's family: ``mesh`` or ``video``, names the per-frame ones);
    None where there is nothing to read."""
    out = {name: setup_s(run, span) for name, span in SETUP.items()}
    out.update({
        f"glue_ms.{suffix}": glue_ms(run),
        f"walk_launch_ms.{suffix}": ms_per_frame(run, WALKS),
        f"pull_wait_ms.{suffix}": ms_per_frame(run, ("pull.wait",)),
        f"pull_write_ms.{suffix}": ms_per_frame(run, ("pull.write",)),
        f"walk_visits.{suffix}": walk_visits(run),
        f"idle_glue_pct.{suffix}": idle_glue_pct(run),
    })
    return out


def alignment(run, kernel="nearest_stream_kernel"):
    """The traced frames' walk kernels against their spans on the mapped
    clock: the k-th ``kernel`` operation of the trace must start after the
    start of the k-th ``dispatch.walk`` span and before the end of that
    frame's ``frame.pull``.  Returns (kernels checked, [faults])."""
    tr = run["traced"]
    off = tr["offset"]
    frames = set(traced_frames(run))
    walks = sorted((s for s in spans(run, "dispatch.walk")
                    if s["frame"] in frames), key=lambda s: s["start"])
    pulls = {s["frame"]: s["end"] * NS - off
             for s in spans(run, "frame.pull") if s["frame"] in frames}
    ops = sorted((o for o in tr["ops"] if kernel in o[0]),
                 key=lambda o: o[1])
    if len(ops) != len(walks):
        return len(ops), [f"{len(ops)} kernels, {len(walks)} walk spans"]
    faults = []
    for (name, k0, _k1), w in zip(ops, walks):
        w0 = w["start"] * NS - off
        end = pulls.get(w["frame"])
        if end is None or not w0 <= k0 <= end:
            faults.append(f"frame {w['frame']}: kernel at {k0:.6f} s, walk "
                          f"span from {w0:.6f}, pull ends at {end}")
    return len(ops), faults


def run_cell(name, seed, seconds, trace_on=True, program=True, **kw):
    """``gbench.cell.run_cell`` with the program's tracing on (``program``)
    from before the scene is built; returns (result, lines, notes, run),
    ``run`` the dict its metrics read, with the program's records under
    ``"program"``.  ``run`` is taken from the first metric's read."""
    from ntracer_tpu_torch import tracing

    from . import cell, spec

    got = {}
    load = spec.load_module

    def load_module(kind, mod_name, root=spec.BENCH_DIR):
        mod = load(kind, mod_name, root)
        if kind == "metrics":
            inner = mod.read

            def read(run):
                got.setdefault("run", run)
                return inner(run)
            mod.read = read
        return mod

    tracing.drain()
    spec.load_module = load_module
    if program:
        tracing.enable()
    try:
        result, lines, notes = cell.run_cell(
            name, seed, seconds, trace_on, time.perf_counter(), **kw)
    finally:
        tracing.disable()
        spec.load_module = load
    run = got.get("run")
    records = tracing.drain()
    if run is not None:
        run["program"] = records
    return result, lines, notes, run
