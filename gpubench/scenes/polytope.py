# Frozen copy of scripts/polytope.py's kaleidoscope construction (mirror_normals, _initial_vertex, polytope_vertices, hull_prototypes) as of commit 5a3cfa5.
"""A regular polytope given its Schläfli symbol, built as scripts/polytope.py
builds it: the vertices are the orbit of the initial vertex under the
Coxeter mirror group, and the boundary is triangulated into
(d-1)-simplices by Qhull, zero-volume slivers dropped.

Configuration keys: ``schlafli`` (integer components), ``material``
(opaque, no reflection: ``color`` and the specular settings), ``fov``, ``cam_dist`` (the camera sits at ``-sqrt(circumradius^2) *
cam_dist`` on axis 2, circumradius 1).
"""

from __future__ import annotations

import math

import numpy as np


def mirror_normals(symbol):
    """Unit normals of the n Coxeter mirrors for {p1,...,p_{n-1}}: the Gram
    matrix has -cos(pi/p_i) between consecutive mirrors, 0 otherwise."""
    n = len(symbol) + 1
    gram = np.eye(n)
    for i, p in enumerate(symbol):
        c = -math.cos(math.pi / float(p))
        gram[i, i + 1] = gram[i + 1, i] = c
    normals = np.zeros((n, n))
    for i in range(n):
        for j in range(i):
            normals[i, j] = (gram[i, j]
                             - normals[i, :j] @ normals[j, :j]) / normals[j, j]
        s = 1.0 - normals[i, :i] @ normals[i, :i]
        if s <= 0:
            raise ValueError("Schläfli symbol does not describe a finite polytope")
        normals[i, i] = math.sqrt(s)
    return normals


def _initial_vertex(normals):
    """Point on all mirrors except mirror 0, normalized."""
    _, _, vt = np.linalg.svd(normals[1:])
    v0 = vt[-1]
    return v0 / np.linalg.norm(v0)


def _reflect(v, m):
    return v - 2.0 * (v @ m) * m


def polytope_vertices(symbol):
    """Vertices as the orbit of the initial vertex under the mirror group."""
    normals = mirror_normals(symbol)
    v0 = _initial_vertex(normals)
    verts = [v0]
    seen = {tuple(np.round(v0, 6))}
    queue = [v0]
    while queue:
        v = queue.pop()
        for m in normals:
            r = _reflect(v, m)
            key = tuple(np.round(r, 6))
            if key not in seen:
                seen.add(key)
                verts.append(r)
                queue.append(r)
    return np.asarray(verts)


def hull_simplices(verts):
    """The hull's boundary (d-1)-simplices, (N, d, d) float32, with Qhull's
    zero-volume slivers dropped (hull_prototypes)."""
    from scipy.spatial import ConvexHull

    keep = []
    for simplex in ConvexHull(verts).simplices:
        pts = verts[simplex]
        edges = pts[1:] - pts[0]
        vol2 = np.linalg.det(edges @ edges.T)
        scale = np.prod(np.linalg.norm(edges, axis=1)) or 1.0
        if np.isfinite(vol2) and abs(vol2) >= (1e-6 * scale) ** 2:
            keep.append(pts)
    return np.asarray(keep, dtype=np.float32)


def dimension(config):
    return max(len(config["schlafli"]) + 1, 3)


def camera_distance(config):
    return -float(config["cam_dist"])


def simplices(config, cache_dir):
    """The geometry both sides are given: (N, d, d) float32."""
    return hull_simplices(polytope_vertices([int(c) for c in config["schlafli"]]))


def prototypes(config, nt, tris, cache_dir):
    """The prototypes as the script makes them (hull_prototypes' batch
    constructor, one material)."""
    from ntracer_tpu_torch import Material
    m = config["material"]
    mat = Material(tuple(m["color"]), 1.0, 0.0, m["specular_intensity"],
                   m["specular_exp"], tuple(m["specular_color"]))
    return nt.TrianglePrototype.batch_from_points(tris, mat)
