"""Arithmetic the metric readers share: frames of the window, rates, tails,
span and trace sums.  A record is (frame, began, done) on the host clock;
``done`` is None for a frame whose bytes never came."""

from __future__ import annotations

import numpy as np

from . import trace


def done_in_window(run):
    """The records of the frames whose bytes were in the buffer before the
    window closed."""
    return [r for r in run["records"]
            if r[2] is not None and r[2] <= run["t_w1"]]


def frames_in_window(run):
    """The frames done in the window, and of the next frame the share of
    its completion interval (from the last frame done in the window to its
    own) that lies in the window: the work of a frame still in flight when
    the window closes counts by the time it had, so the count does not
    step by whole frames."""
    done = sorted(r[2] for r in run["records"] if r[2] is not None)
    n = len(done_in_window(run))
    if n == len(done):
        return float(n)
    prev = done[n - 1] if n else run["t_w0"]
    return n + (run["t_w1"] - prev) / (done[n] - prev)


def mrays_s(run):
    """Rays of the frames done in the window (``frames_in_window``) over the
    window's seconds, in millions a second."""
    f = run["fmt"]
    return frames_in_window(run) * f["width"] * f["height"] \
        / run["seconds"] / 1e6


def p95_ms(run):
    """The 95th percentile (numpy's linear interpolation) of the host time
    from a frame's begin to its bytes, over the frames done in the window."""
    lat = [1e3 * (r[2] - r[1]) for r in done_in_window(run)]
    return float(np.percentile(lat, 95)) if lat else None


def span_ms_per_frame(run, name):
    """Host milliseconds a frame in the spans ``name`` that began in the
    window: their sum over the number of such spans (one a frame)."""
    spans = [(a, b) for a, b in run["spans"].get(name, ())
             if run["t_w0"] <= a < run["t_w1"]]
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)


def device_idle_pct(run):
    """The share of the traced window in which no operation ran on the
    device, in percent."""
    tr = run["traced"]
    if not tr or not tr["ops"]:
        return None
    busy = sum(e - s for s, e in trace.busy(tr["ops"]))
    return 100.0 * (1.0 - busy / tr["window_s"])


def kernel_ms_per_frame(run, name_part):
    """Device milliseconds a traced frame in the kernels whose name holds
    ``name_part``; None when no such kernel ran."""
    tr = run["traced"]
    if not tr:
        return None
    ms = [1e3 * (e - s) for n, s, e in tr["ops"] if name_part in n]
    return sum(ms) / tr["frames"] if ms else None
