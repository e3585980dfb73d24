# Frozen copy, as data, of the orbit of scripts/polytope.py (advance_camera) as of commit 5a3cfa5.
"""Camera paths: orbits about the scene's centre, as upstream's
scripts/polytope.py makes them.

``advance_camera`` turns the camera a fixed angle a frame in one plane and
pins its origin to ``axes[2] * cam_distance``, so the camera circles the
centre looking at it.  A traffic file names the plane: polytope.py's own
(its view axis and the diagonal of its other axes), or another, such as
scripts/hypercube.py's plane of world axes 2 and 0 (hypercube.py itself
turns the camera in place).  The plane is fixed, so frame ``k`` is the
start camera turned by ``k`` steps: this module computes it that way in
float64 (no drift over a long window, the same cameras every turn) and
hands both sides float32 cameras.

A traffic file's ``camera`` says::

    {"steps_per_turn": 160, "from": [2], "to": "others"}

``from`` and ``to`` list camera axes whose normalized sums span the plane
(``"others"``: every axis not in ``from``); the rotation is
``Matrix.rotation(a, b, step)`` of the port's API (geometry.hpp:577-591),
which turns ``a`` away from ``b``.  The seed picks the starting step.
"""

from __future__ import annotations

import math

import numpy as np


def rotation(a, b, theta):
    """The plane rotation of ``Matrix.rotation(a, b, theta)`` in float64:
    p -> p + (p.a)(a (c-1) - b s) + (p.b)(b (c-1) + a s)."""
    c, s = math.cos(theta) - 1.0, math.sin(theta)
    return (np.eye(len(a)) + c * (np.outer(a, a) + np.outer(b, b))
            + s * (np.outer(b, a) - np.outer(a, b)))


def _unit_sum(axes, idx):
    v = axes[list(idx)].sum(axis=0)
    return v / np.linalg.norm(v)


def start_step(spec, seed):
    return int(np.random.default_rng(int(seed)).integers(spec["steps_per_turn"]))


def cameras(d, distance, spec):
    """(origins (n, d), axes (n, d, d)) float32 of every step of one turn,
    from the upstream start camera: identity axes, the origin at
    ``distance`` on axis 2."""
    n = int(spec["steps_per_turn"])
    axes0 = np.eye(d)
    frm = spec["from"]
    to = [i for i in range(d) if i not in frm] if spec["to"] == "others" \
        else spec["to"]
    a, b = _unit_sum(axes0, frm), _unit_sum(axes0, to)
    origins = np.empty((n, d), np.float32)
    axes = np.empty((n, d, d), np.float32)
    for k in range(n):
        r = rotation(a, b, 2 * math.pi * k / n)
        ax = axes0 @ r.T
        axes[k] = ax
        origins[k] = ax[2] * distance
    return origins, axes
