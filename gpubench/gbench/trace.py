"""The device trace of a traced run: torch.profiler over a few frames.

What it keeps: every device operation (kernels, copies, sets) as (name,
start, end) in seconds from the traced window's start, and the window's
length.  The window is the ``gbench.window`` range on the host; host spans
(``loops.Spans``, on ``time.perf_counter``) are put on the same timeline by
the offset between that range's start on both clocks.
"""

from __future__ import annotations

import bisect
from time import perf_counter as clock


def profile(run_frames, cuda):
    """Run ``run_frames()`` under the profiler.  Returns (device ops
    [(name, start_s, end_s)], window_s, host offset) where a host time ``t``
    on ``clock`` is ``t - offset`` on the trace's timeline."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_, \
        record_function

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with prof_(activities=acts) as prof:
        with record_function("gbench.window"):
            t_host = clock()
            run_frames()
            if cuda:
                torch.cuda.synchronize()
    events = prof.events()
    win = [e for e in events if e.name == "gbench.window"
           and e.device_type.name == "CPU"][0]
    w0, w1 = win.time_range.start, win.time_range.end
    ops = []
    for e in events:
        # the host ranges' mirrors on the device timeline are no operation
        if e.device_type.name != "CUDA" or e.name.startswith("gbench."):
            continue
        s = max(e.time_range.start, w0)
        t = min(e.time_range.end, w1)
        if t > s:
            ops.append((e.name, (s - w0) / 1e6, (t - w0) / 1e6))
    return ops, (w1 - w0) / 1e6, t_host


def busy(ops):
    """The union of the device operations' intervals, as sorted disjoint
    (start, end) pairs."""
    out = []
    for _name, s, e in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def gaps(ops, window_s):
    """The idle intervals of the window."""
    out, t = [], 0.0
    for s, e in busy(ops):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if window_s > t:
        out.append((t, window_s))
    return out


def short_name(name):
    """A kernel's name without its argument list and namespace noise."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:160]


def by_name(ops):
    """Device seconds by operation name (``short_name``), largest first."""
    tot = {}
    for name, s, e in ops:
        name = short_name(name)
        tot[name] = tot.get(name, 0.0) + (e - s)
    return sorted(tot.items(), key=lambda kv: -kv[1])


def idle_by_host(ops, window_s, host_spans, offset):
    """Idle seconds of the window by what the host was doing: each gap is
    given to the host span (``{name: [(t0, t1)]}`` on ``clock``) that
    overlaps it most (of the 16 that began last before its end), else to
    ``"other"``.  Returns [(label, seconds)],
    largest first, the label with the number of gaps."""
    spans = [(name, a - offset, b - offset)
             for name, pairs in host_spans.items() for a, b in pairs]
    spans.sort(key=lambda s: s[1])
    starts = [s[1] for s in spans]
    tot, count = {}, {}
    for g0, g1 in gaps(ops, window_s):
        best, label = 0.0, "other"
        hi = bisect.bisect_left(starts, g1)
        for name, a, b in spans[max(0, hi - 16):hi]:
            ov = min(b, g1) - max(a, g0)
            if ov > best:
                best, label = ov, name
        tot[label] = tot.get(label, 0.0) + (g1 - g0)
        count[label] = count.get(label, 0) + 1
    return sorted(((f"{k} ({count[k]} gaps)", v) for k, v in tot.items()),
                  key=lambda kv: -kv[1])
