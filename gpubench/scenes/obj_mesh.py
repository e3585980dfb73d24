# Frozen copy of chip_smoke.py's sphere_mesh and write_obj (the mesh of scripts/bench_mesh.py) and of scripts/hypercube.py's --obj scene (load_obj, camera on axis 2) as of commit 5a3cfa5.
"""A 3-D Wavefront OBJ mesh loaded as scripts/hypercube.py --obj loads one:
``load_obj`` (fan triangulation, white material), one k-d scene.

The mesh is the lat/long sphere of scripts/bench_mesh.py.  Its OBJ file is
written once a checkout into ``cache_dir`` (nine significant digits, so
every float32 reads back exactly) and read by ``load_obj`` in every run.

Configuration keys: ``tris`` (the sphere's target triangle count),
``cam_dist`` (the camera sits at ``cam_dist`` on axis 2), ``fov``.
"""

from __future__ import annotations

import math
import os

import numpy as np


def sphere_mesh(n_target):
    """Lat/long tessellated unit sphere with ~n_target triangles.
    Degenerate triangles are dropped, the polar rings with them: the sphere
    has a small hole at each pole."""
    rows = max(4, int(math.sqrt(n_target / 4)))
    cols = 2 * rows
    th = np.linspace(0, math.pi, rows + 1)
    ph = np.linspace(0, 2 * math.pi, cols + 1)
    v = np.empty((rows + 1, cols + 1, 3), np.float32)
    v[..., 0] = np.sin(th)[:, None] * np.cos(ph)[None, :]
    v[..., 1] = np.sin(th)[:, None] * np.sin(ph)[None, :]
    v[..., 2] = np.cos(th)[:, None]
    tris = []
    for i in range(rows):
        for j in range(cols):
            a, b, c, d = v[i, j], v[i + 1, j], v[i + 1, j + 1], v[i, j + 1]
            if i:
                tris.append((a, b, c))
            if i != rows - 1:
                tris.append((a, c, d))
    tris = np.asarray(tris, np.float32)
    area = np.linalg.norm(np.cross(tris[:, 1] - tris[:, 0],
                                   tris[:, 2] - tris[:, 0]), axis=1)
    return tris[area > 1e-10]


def write_obj(tris, path):
    """``tris`` (N, 3, 3) as a Wavefront OBJ file: three vertices a
    triangle, nine significant digits (every float32 reads back exactly)."""
    with open(path, "w") as f:
        np.savetxt(f, tris.reshape(-1, 3), fmt="v %.9g %.9g %.9g")
        np.savetxt(f, np.arange(1, 3 * len(tris) + 1).reshape(-1, 3),
                   fmt="f %d %d %d")


def dimension(config):
    return 3


def camera_distance(config):
    return float(config["cam_dist"])


def simplices(config, cache_dir):
    return sphere_mesh(int(config["tris"]))


def obj_path(config, cache_dir):
    return os.path.join(cache_dir, f"sphere_{int(config['tris'])}.obj")


def prototypes(config, nt, tris, cache_dir):
    """Write the OBJ file if this checkout has none yet (to a temporary
    name first, so a run never reads half a file), then load it."""
    from ntracer_tpu_torch.wavefront_obj import load_obj
    path = obj_path(config, cache_dir)
    if not os.path.isfile(path):
        os.makedirs(cache_dir, exist_ok=True)
        part = f"{path}.{os.getpid()}.part"
        write_obj(tris, part)
        os.replace(part, path)
    return load_obj(path, nt)
