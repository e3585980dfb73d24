"""Wavefront OBJ loader, vectorized for the SoA engine.

Behavioral contract (reference lib/ntracer/wavefront_obj.py:12-45): only
``v`` and ``f`` records matter, vertices take their first three floats,
faces fan-triangulate, indices are 1-based with OBJ's negative relative
indexing, and malformed records raise ``FileFormatError``.  Unlike the
reference's per-line object construction, this parses the whole file into
numpy arrays first — building N TrianglePrototypes dominates load time,
so the vertex table is converted once.

The port's copy of ``ntracer_tpu/wavefront_obj.py``: the same parser, with
``load_obj`` returning this package's ``TrianglePrototype``s.
"""

from __future__ import annotations

import numpy as np

from . import render
from . import tracing
from . import wrapper


class FileFormatError(Exception):
    def __init__(self):
        super().__init__("not a valid wavefront file")


def _parse(file):
    """One pass over the file -> (vertex array (V,3), face index lists).

    Face vertex references keep only the vertex index (before any '/');
    negative values count back from the vertices seen SO FAR, per spec."""
    verts = []
    faces = []
    with open(file, "r") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                try:
                    verts.append((float(parts[1]), float(parts[2]),
                                  float(parts[3])))
                except (ValueError, IndexError):
                    raise FileFormatError()
            elif tag == "f":
                try:
                    idx = [int(p.partition("/")[0], 10) for p in parts[1:]]
                except ValueError:
                    raise FileFormatError()
                n = len(verts)
                # 1-based absolute, or negative relative to the current
                # vertex count; anything out of range is malformed
                res = []
                for i in idx:
                    j = i - 1 if i >= 0 else n + i
                    if not 0 <= j < n:
                        raise FileFormatError()
                    res.append(j)
                faces.append(res)
    return np.asarray(verts, dtype=np.float32).reshape(len(verts), 3), faces


def load_obj(file, nt=None):
    """Load a 3-D OBJ mesh as a list of TrianglePrototypes (fan
    triangulation, default white material); the span ``scene.load_obj``."""
    with tracing.span("scene.load_obj"):
        return _load_obj(file, nt)


def _load_obj(file, nt):
    if nt is None:
        nt = wrapper.NTracer(3)
    elif nt.dimension != 3:
        raise ValueError(
            "Wavefront .obj files only support 3-dimensional geometry")

    verts, faces = _parse(file)
    mat = render.Material((1, 1, 1))

    tris = []
    for face in faces:
        v = verts[face]
        for i in range(1, len(face) - 1):
            tris.append((v[0], v[i], v[i + 1]))
    if not tris:
        return []
    from .primitives import TrianglePrototype
    # vectorized batch constructor (bit-identical fields to the scalar
    # one) — per-object construction dominates large OBJ loads
    return TrianglePrototype.batch_from_points(
        np.asarray(tris, dtype=np.float32), mat)
