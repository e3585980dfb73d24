"""What decides ``correct``: the bytes the timed window left in the caller's
buffers, against the plain reference (``reference.py``).

The frames compared are the window's frames whose bytes the loop kept (a
sample drawn from the seed) and the last frame in each buffer.  In each,
``pixels`` pixels drawn from the seed are worked out by the reference in
float64 from the simplices and the frame's camera, and a pixel is off when
one of its channels differs from the program's by more than ``tolerance``
(in the channel's own units).  The number compared is the share of off
pixels in the worst frame, against the limit of the traffic file.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference

GAP_BINS = (0, 1, 2, 5, 17, 257)
GAP_NAMES = ("0", "1", "2-4", "5-16", "17-256", ">256")


def channel_values(buf, fmt, xs, ys):
    """The (R, 3) channel values of the pixels ``xs``, ``ys`` of a packed
    frame of three equal integer channels of 8 or 16 bits, MSB first."""
    bits = fmt["bits"]
    nb = bits // 8
    a = np.frombuffer(bytes(buf), np.uint8)
    off = ys * fmt["pitch"] + xs * 3 * nb
    out = np.zeros((len(xs), 3), np.int64)
    for c in range(3):
        for k in range(nb):
            out[:, c] = (out[:, c] << 8) | a[off + c * nb + k]
    return out


def sample_pixels(seed, frame, width, height, count):
    """``count`` distinct pixels of a frame drawn from the seed, as (xs,
    ys)."""
    rng = np.random.default_rng([abs(int(seed)), int(frame), 7])
    flat = rng.choice(width * height, size=min(count, width * height),
                      replace=False)
    return flat % width, flat // width


def kept_frames(seed, chk):
    """Frame numbers whose bytes the window keeps: drawn from the seed among
    the first ``within_frames``."""
    rng = np.random.default_rng([abs(int(seed)), 11])
    n = int(chk["within_frames"])
    return sorted(int(k) for k in rng.choice(n, size=int(chk["frames"]),
                                             replace=False))


def compare(frames, tris, scene, fmt, seed, pixels, tolerance, device,
            reference_pixels=None):
    """``frames`` is a list of (frame index, origin, axes, bytes).  Returns
    the per-frame shares of off pixels and a count of the compared pixels by
    their largest channel gap (0, 1, 2-4, 5-16, 17-256, over 256).
    ``reference_pixels`` stands in for ``reference.pixels`` (the control
    puts a lower precision in the program's place this way)."""
    rows = reference.simplex_rows(tris, torch.float64, device)
    shares, hist = [], np.zeros(len(GAP_BINS), np.int64)
    for k, origin, axes, buf in frames:
        xs, ys = sample_pixels(seed, k, fmt["width"], fmt["height"],
                               pixels)
        want = reference.pixels(tris, scene, origin, axes, fmt["width"],
                                fmt["height"], xs, ys, fmt["bits"],
                                torch.float64, device, rows=rows)
        want = want.cpu().numpy()
        if reference_pixels is None:
            got = channel_values(buf, fmt, xs, ys)
        else:
            got = reference_pixels(origin, axes, xs, ys)
        diff = np.abs(got - want).max(axis=1)
        shares.append(float((diff > tolerance).mean()))
        hist += np.histogram(diff, bins=list(GAP_BINS) + [np.inf])[0]
    return shares, dict(zip(GAP_NAMES, hist.tolist()))
