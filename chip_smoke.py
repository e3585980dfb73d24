#!/usr/bin/env python3
"""Smoke run of ntracer_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ntracer_tpu_torch/csrc, holds each kernel
against its plain PyTorch twin on the card at the main paths' shapes, then
drives the main paths as a user does, through ``BlockingRenderer().render``
at 1024x1024, 8-bit RGB:

  * the flagship: bench.py's 4-D 120-cell {5,3,3}, an 8-frame camera orbit
    (one nearest-hit walk a frame);
  * the lit configuration: scripts/bench_suite.py's 6-D scene of 900 random
    simplices with two point lights, one global light and shadows on, a
    4-frame orbit (one nearest-hit walk and three occlusion walks a frame);
  * the lit 120-cell: the flagship's geometry under a point and a global
    light with shadows on, a 4-frame orbit (one nearest-hit walk and two
    occlusion walks a frame, most ray blocks live), and one frame of
    scripts/tpu_parity.py's "shadows d=3" scene (700 opaque triangles that
    shade each other: a convex body casts no shadow on itself);
  * the glass 120-cell: the same geometry with every other simplex of
    glass (opacity 0.4) under the same lights, a 4-frame orbit (one
    transparent walk and (K + 1) x 2 = 18 filtered occlusion walks a frame,
    K = 8 transparent slots a ray);
  * one frame of scripts/tpu_parity.py's "transparent d=3" scene (500 glass
    triangles: rays cross more surfaces than they have slots);
  * the mesh: scripts/bench_mesh.py's sphere of 495,612 triangles
    (``sphere_mesh(500000)``), written to an OBJ file and loaded with the
    port's ``load_obj``, under tpu_parity.py's two lights with shadows on, a
    4-frame orbit.  Its pool (4,054 chunks, 63.3 MiB) is over the line
    (``resident_kernels.STREAM_POOL_BYTES``), so it renders through the
    streaming walks: one ``nearest_hit_hbm`` and two ``occluded_hbm`` a
    frame;
  * the glass mesh: the same triangles by turns opaque and glass (opacity
    0.4), the same lights, a 4-frame orbit (one
    ``nearest_hit_transparent_hbm`` and 18 ``occluded_transparent_hbm`` a
    frame);
  * the orthoplex d=10: scripts/polytope.py's 10-orthoplex {3,...,3,4}
    (1,024 simplices, two 512-triangle tiles) from its camera at -4 on axis
    2, fov 0.8, under tpu_parity.py's two lights (the point light at
    (0, 3, -3, 1, 0, ...)) with shadows on, a 4-frame orbit.  A scene of
    more than 8 dimensions takes the grid walks (kernels 2.9 and 2.10:
    ``grid_kernels.nearest_hit`` and ``occluded``): one 2.9 and two 2.10
    launches a frame;
  * one frame of scripts/tpu_parity.py's "generic d=10" (40 random 10-D
    simplices, ``NTracer(10, force_generic=True)``) under the same lights;
  * the wide d=20: the regular 20-simplex (``polytope_vertices([3] *
    19)``, scripts/polytope.py with nineteen 3s: 21 facets) among 200
    random 20-D simplices (``wide_scene``), the camera turned 0.6 rad off
    the axis view, the same lights, a 4-frame orbit: past d = 16 the grid
    walks run their wide bodies, one 2.9 and two 2.10 launches a frame;
  * solids, each scene hand-built into one k-d leaf (``leaf_scene``; the
    reference's build misplaces solids, PARITY.md defects 6 and 9):
    "solids d=4", scripts/tpu_parity.py's cube, sphere and 12 triangles
    under the two lights (kernels 2.1 and 2.2, a 4-frame orbit); "glass
    solids d=3", tests/test_engine.py's 600 triangles (one in ten of glass),
    glass cube and opaque sphere under a point light, K = 8 (kernels 2.3
    and 2.4, the cube in the K slots, a 4-frame orbit); "solid orthoplex
    d=10", the orthoplex and an opaque 10-cube beside it (kernels 2.9 and
    2.10, a 4-frame orbit); and one frame of the "glass orthoplex d=10", by
    turns opaque and glass, with a glass 10-sphere: a transparent pool of
    d > 8 takes the chunk scan (``wavefront.trace_scan`` and
    ``occlusion_scan``, plain torch, no kernel) for its trace and its 18
    shadow queries.  Their stage times add ``solids`` (every solid's test
    on the primary wavefront) and, for the scan, ``scan``; each path's
    primary walk is held against its twin on the frame's wavefront, and the
    scan on the card against the scan on the CPU for one group of rays.

Then the renderer front end: the flagship orbit through
``CallbackRenderer()``, all eight frames in flight and then three buffers,
the camera turned after each ``begin_render`` (each frame's bytes equal
``BlockingRenderer``'s, callbacks in FIFO order; ``begin_render``'s return
time, the pipelined and the blocking frame rates, the device frame time),
an abort with frames queued, ``lit_config`` through ``CallbackRenderer``, a
30/30/4-bit format through both renderers (bytes equal ``packing.pack_rows``
of the card's colors, no device packing) and a 32-row strip at y0 = 500
against the CPU's; and the apps, ``scripts/polytope.py 5 3 3`` and
``scripts/hypercube.py -d 4`` with ``--benchmark`` at 1024x1024, run
unmodified through ``python -m ntracer_tpu_torch.alias``.

Then several devices on the one card (phase "multi-device"): a mesh there
is shards of ``cuda:0`` run one after another
(``parallel.mesh.make_mesh(..., devices=[cuda:0] * n)``), so every code
path of the sharding runs, copies between two cards excepted.  The
flagship's frame split over a px mesh of four through ``BlockingRenderer``
(``wavefront.render_devices`` giving the card four times) has the single
frame's bytes; ``parallel.mesh.render_frame`` over prim meshes 1x2 and 2x2
of the lit 120-cell (2.1 and 2.2 a shard), the glass 120-cell (2.3, 2.4,
the K merge and the ``filt`` product), "solids d=4" (solids on shard 0
only) and the orthoplex d=10 (2.9 and 2.10 a shard), and 1x2 of the mesh
(each half under the line: 2.1 and 2.2 in place of 2.5 and 2.6), each
against the single frame (bytes that differ), held to the oracle at the
pixels of the scene's oracle check, with the walk each shard takes, the
walks a shard ran, the kernel launches and the host and device frame
times beside the single frame's.  And the counters (phase "counters"):
``wavefront.frame_stats`` of the flagship, lit, lit 120-cell, glass
120-cell, mesh, orthoplex and glass orthoplex frames, and the card's
counts of a small lit glass scene equal to the CPU's.

Each streaming kernel is held against its twin at the mesh's full
wavefronts, and against its sibling for pools under the line (kernels
2.1-2.4) on the same inputs (2.1, 2.2 and 2.4 launch 2.5's, 2.6's and 2.8's
bodies: those checks are of equality, not of time; 2.3 launches 2.7's in
groups of one, so the two share t and the opaque slot, and their times
compare the group sizes); the grid kernels against their twins at the
orthoplex's full
wavefronts (primary rays with the shared rows, the bounce wavefront, shadow
rays to three lights and a dead wavefront), at d = 9 (the 9-orthoplex)
and d = 16 (200 random simplices, rays aimed at them) for other d, and
past d = 16 (the wide bodies) on the wide d=20 frame's primary, bounce
and global-light shadow wavefronts (the last two with few live rays, in
few blocks) and on pools of 200 random simplices at d = 17, 24, 32, 57 and
64 built straight from their rows (``simplex_pool``: the k-d build of such
scenes takes minutes), rays aimed at them from the camera with the shared
rows and with their own origins (for 2.10 the same rays up to the next
float past their hit on even rays, up to the hit on odd rays).  The
post-walk glue kernel (``wavefront.shade_pack``, csrc/shade_pack.cu;
phase "glue kernel vs plain", ``glue_kernel``) is held against its plain
version byte for byte and timed beside its bytes bound at the benchmark
cells' frames: the flagship 120-cell and the unlit orthoplex at 1920x1080
in 16 bits, the unlit mesh at 1024x1024 in 8 bits.  The script checks 64 pixels of each frame against the scalar NumPy
oracle, computed by forked worker processes on the host (5e-5;
5e-4 for the composed pixels of the transparent frames), chosen from the
engine's own masks: the lit 120-cell's with at least 16 shadowed pixels, the
shadows d=3 frame's with at least 16 pixels in a cast shadow, the glass
120-cell's with at least 16 pixels seen through glass and 8 lit through
glass.  Both 120-cell frames are checked from a camera turned 0.6 rad off
the axis view: that view is a mirror hyperplane of the polytope, its rays
meet mirrored simplices on their common boundary, and there the last bit
decides (tests/test_torch_mirror_view.py); so are both mesh frames (the
axis camera looks through the sphere's polar holes), the orthoplex and the
four solid scenes (their pixels drawn a third or more from those whose ray
meets a solid).
Each kernel's launch count is set to 0 before a path is driven and read
after it; one more glass 120-cell frame counts kernel 2.4's live launches
(a block visited a chunk).  The script prints the launch of 2.1 at d = 4
and 6 and of 2.4 (stream_walk.cuh's bodies), of 2.9 and 2.10 at d = 9, 10,
16, 17, 20, 24 and 32 (registers, spills, blocks an SM, ring slots, rays a
thread), and
the time of 2.1's entry pass alone on the flagship pool.  Any failed phase exits
non-zero.  The last two lines of output are one JSON object with every
kernel's numbers and ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when torch finds no CUDA device.
"""

import json
import math
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
W = H = 1024
FRAMES = 8                 # flagship orbit
LIT_FRAMES = 4             # lit, lit 120-cell and glass 120-cell orbits
CALLBACK_FRAMES = 8        # the flagship orbit through CallbackRenderer
CALLBACK_DEPTH = 3         # its buffers in the timed runs
CALLBACK_ROUNDS = 4        # timed rounds of both loops, in turns
APP_FRAMES = 30            # polytope.py -f, hypercube.py -f2
ORACLE_PIXELS = 64
ORACLE_TOL = 5e-5          # tests/test_pallas.py:356
ORACLE_TOL_GLASS = 5e-4    # composed pixels, tests/test_engine.py:89
ORACLE_MAX_OVER = 2
OBLIQUE = 0.6              # radians off the axis view, for the oracle's frames
MESH_TRIS = 500000         # scripts/bench_mesh.py --tris 500000
MESH_DISTANCE = -3.0       # scripts/bench_mesh.py's camera
# processes that compute the oracle's pixels (the card's host has 8 cores)
ORACLE_WORKERS = min(8, len(os.sched_getaffinity(0)))
# the solid types, ntracer_tpu_torch.CUBE and SPHERE (the reference's values)
CUBE, SPHERE = 1, 2

# The card's rates.  The kernels are built with --fmad=false, so a lane
# starts one float32 add or one multiply a clock, never a fused pair: the
# float32 rate is 132 SMs x 128 lanes x the maximum SM clock
# (nvidia-smi --query-gpu=clocks.max.sm: 1,980 MHz on the H100 SXM), half
# the data sheet's 67 TFLOP/s, which counts an FMA as two operations.
# Device memory: the data sheet's 3.35 TB/s.
SMS, LANES, MAX_SM_CLOCK = 132, 128, 1.98e9
PEAK_FP32 = SMS * LANES * MAX_SM_CLOCK      # float32 instructions/s
PEAK_BYTES = 3.35e12       # bytes/s
# Instructions an IEEE division (div.rn.f32) executes on its fast path in the
# card's SASS, counted by div_sass_ops() from the same nvcc flags.
DIV_OPS = 10
# Kernels 2.1-2.8 run the loop of stream_walk.cuh (compacted rays, the
# straight-line pair test, per-warp slot release).
REDESIGNED = "ntracer_tpu_torch/csrc/stream_walk.cuh"
# Kernels 2.9 and 2.10 run grid_nearest_kernel<D, SHARED, RPT> and
# grid_occluded_kernel<D, RPT> (exact width, RPT rays a thread, one
# straight-line pair test with warp-uniform skips, a TMA ring of sub-tiles).
GRID_REDESIGNED = ("ntracer_tpu_torch/csrc/grid_walk.cu: grid_pair and "
                   "grid_tiles")
# Past d = 16 they run the wide bodies wide_nearest_kernel<SHARED> and
# wide_occluded_kernel (wide_walk: d at run time, the same shared memory at
# every d, a tile dealt out to the warps over the compacted live rays):
# held against their twins on pools of these d, past 56 too (where the
# first wide bodies ran out of shared memory).
WIDE_BODIES = ("ntracer_tpu_torch/csrc/grid_walk.cu: wide_walk "
               "(wide_nearest_kernel, wide_occluded_kernel; d >= 17)")
WIDE_POOL_DS = (17, 24, 32, 57, 64)
DIV_PROBE = r"""
extern "C" __global__ void ntr_div_probe(float* a, const float* b) {
  a[threadIdx.x] = a[threadIdx.x] / b[threadIdx.x];
}
extern "C" __global__ void ntr_mul_probe(float* a, const float* b) {
  a[threadIdx.x] = a[threadIdx.x] * b[threadIdx.x];
}
"""


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   ({time.perf_counter() - t0:.2f} s)", flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def polytope_vertices(symbol):
    """Vertices of a regular polytope: the orbit of the initial vertex under
    its Coxeter mirror group (the construction of scripts/polytope.py)."""
    n = len(symbol) + 1
    gram = np.eye(n)
    for i, p in enumerate(symbol):
        gram[i, i + 1] = gram[i + 1, i] = -math.cos(math.pi / float(p))
    normals = np.zeros((n, n))
    for i in range(n):
        for j in range(i):
            normals[i, j] = (gram[i, j] - normals[i, :j] @ normals[j, :j]) \
                / normals[j, j]
        normals[i, i] = math.sqrt(1.0 - normals[i, :i] @ normals[i, :i])
    v0 = np.linalg.svd(normals[1:])[2][-1]
    v0 = v0 / np.linalg.norm(v0)
    verts, seen, queue = [v0], {tuple(np.round(v0, 6))}, [v0]
    while queue:
        v = queue.pop()
        for m in normals:
            r = v - 2.0 * (v @ m) * m
            key = tuple(np.round(r, 6))
            if key not in seen:
                seen.add(key)
                verts.append(r)
                queue.append(r)
    return np.asarray(verts)


def hull_simplices(verts):
    """Boundary (d-1)-simplices of the hull as an (N, d, d) float32 array of
    vertices, zero-volume slivers dropped (scripts/polytope.py
    hull_prototypes)."""
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


def hull_prototypes(nt, verts, material):
    """The hull's boundary simplices as prototypes.  ``material`` is one
    Material or a function of the simplex's index."""
    keep = hull_simplices(verts)
    if callable(material):
        material = [material(i) for i in range(len(keep))]
    return nt.TrianglePrototype.batch_from_points(keep, material)


def lit_scene(nt, Material, n=900, seed=3, cam_distance=-8.0):
    """The lit configuration (the construction of scripts/bench_suite.py
    ``lit_config``): ``n`` random simplices, two point lights, one global
    light, shadows on, camera on axis 2.  Returns (scene, camera)."""
    d = nt.dimension
    mat = Material((0.9, 0.6, 0.3))
    rng = np.random.RandomState(seed)
    protos = []
    for _ in range(n):
        base = rng.uniform(-2, 2, d)
        pts = [nt.Vector(*(base + rng.uniform(-0.7, 0.7, d)))
               for _ in range(d)]
        protos.append(nt.TrianglePrototype(pts, mat))
    scene = nt.build_composite_scene(protos)
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, cam_distance))
    scene.set_camera(camera)
    scene.add_light(nt.PointLight(nt.Vector.axis(1, 5), (1, 0.9, 0.7)))
    scene.add_light(nt.PointLight(nt.Vector.axis(0, -5), (0.4, 0.5, 0.9)))
    scene.add_light(nt.GlobalLight(nt.Vector.axis(1, -1), (0.2, 0.2, 0.3)))
    scene.set_shadows(True)
    return scene, camera


def two_lights(nt, scene, point):
    """The two lights of scripts/tpu_parity.py (its point light's color at
    ``point``, its global light along -axis 0), shadows on."""
    scene.add_light(nt.PointLight(nt.Vector(*point), (1, 0.9, 0.7)))
    scene.add_light(nt.GlobalLight(nt.Vector.axis(0, -1), (0.2, 0.2, 0.3)))
    scene.set_shadows(True)
    return scene


def cell120_scene(nt, material, cam_distance, lit):
    """bench.py's 120-cell {5,3,3} seen from ``cam_distance`` on axis 2,
    with ``two_lights`` when ``lit``.  Returns (scene, camera, simplices)."""
    protos = hull_prototypes(nt, polytope_vertices([5, 3, 3]), material)
    scene = nt.build_composite_scene(protos)
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, cam_distance))
    scene.set_camera(camera)
    scene.set_fov(0.8)
    if lit:
        two_lights(nt, scene, (0, 3, -3, 1))
    return scene, camera, len(protos)


def orthoplex_scene(nt, material, cam_distance=-4.0, lit=True):
    """The orthoplex {3,...,3,4} of ``nt``'s dimension as
    scripts/polytope.py renders it (``polytope.py 3 3 3 3 3 3 3 3 4`` at
    d = 10: 1,024 simplices): camera at ``cam_distance`` on axis 2, fov
    0.8, when ``lit`` under ``two_lights`` with the point light at (0, 3,
    -3, 1, 0, ...).  Returns (scene, camera, simplices)."""
    d = nt.dimension
    protos = hull_prototypes(nt, polytope_vertices([3] * (d - 2) + [4]),
                             material)
    scene = nt.build_composite_scene(protos)
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, cam_distance))
    scene.set_camera(camera)
    scene.set_fov(0.8)
    if lit:
        two_lights(nt, scene, (0, 3, -3, 1) + (0,) * (d - 4))
    return scene, camera, len(protos)


def generic_scene(nt, material):
    """scripts/tpu_parity.py's "generic d=10" (``nt`` is ``NTracer(10,
    force_generic=True)``): 40 random 10-D simplices, camera at -9 on axis
    2, here under ``two_lights`` (the point light at (0, 3, -3, 1, 0, ...)),
    shadows on."""
    d = nt.dimension
    rng = np.random.RandomState(5)
    protos = []
    for _ in range(40):
        base = rng.uniform(-2, 2, d)
        pts = [nt.Vector(*(base + rng.uniform(-1.0, 1.0, d)))
               for _ in range(d)]
        protos.append(nt.TrianglePrototype(pts, material))
    scene = nt.build_composite_scene(protos)
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, -9))
    scene.set_camera(camera)
    return two_lights(nt, scene, (0, 3, -3, 1) + (0,) * (d - 4))


def leaf_scene(nt, protos, extent):
    """``protos`` hand-built into one k-d leaf in the box [-extent,
    extent]^d, always visited.  The reference's build places solids off
    their position (PARITY.md defects 6 and 9), so a scene with solids is
    held to the oracle only in this form (scripts/tpu_parity.py:88-117)."""
    d = nt.dimension
    return nt.CompositeScene(nt.AABB((-extent,) * d, (extent,) * d),
                             nt.KDLeaf([p.primitive for p in protos]))


def solids_d4_scene(nt, Material):
    """scripts/tpu_parity.py's "solids+tris d=4": a cube scaled by 0.8 at
    (1.2, 0, 0, 0), a unit sphere at (-1.2, 0, 0, 0) and 12 random
    triangles above them, in one leaf (``leaf_scene``), camera at -7 on
    axis 2, here under ``two_lights`` (the point light at (0, 3, -3, 1)).
    Returns (scene, camera)."""
    mat = Material((0.9, 0.9, 0.5))
    protos = [
        nt.SolidPrototype(CUBE, nt.Vector(1.2, 0, 0, 0), nt.Matrix.scale(0.8),
                          mat),
        nt.SolidPrototype(SPHERE, nt.Vector(-1.2, 0, 0, 0),
                          nt.Matrix.identity(), Material((0.4, 0.9, 0.6))),
    ]
    rng = np.random.RandomState(11)
    for _ in range(12):
        base = rng.uniform(-2, 2, 4) + np.array([0, 2.5, 0, 0])
        pts = [nt.Vector(*(base + rng.uniform(-0.5, 0.5, 4)))
               for _ in range(4)]
        protos.append(nt.TrianglePrototype(pts, mat))
    scene = leaf_scene(nt, protos, 4.0)
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, -7))
    scene.set_camera(camera)
    return two_lights(nt, scene, (0, 3, -3, 1)), camera


def glass_solids_d3_scene(nt, Material):
    """tests/test_engine.py:960-985's scene: 600 random triangles, one in
    ten of glass (opacity 0.45), a glass cube (opacity 0.5) at (0.5, 0, -2)
    and an opaque unit sphere at (-1.5, 0.5, -1), in one leaf, camera at -8
    on axis 2, a point light at (0, 4, -4), shadows on.  Its triangles are
    single primitives, so the oracle keeps every glass surface.  Returns
    (scene, camera)."""
    glass = Material((0.9, 0.7, 0.4), opacity=0.45)
    opaque = Material((1, 0.5, 0.5))
    rng = np.random.RandomState(41)
    protos = []
    for i in range(600):
        base = rng.uniform(-2, 2, 3)
        pts = [nt.Vector(*(base + rng.uniform(-0.8, 0.8, 3)))
               for _ in range(3)]
        protos.append(nt.TrianglePrototype(pts, glass if i % 10 == 0
                                           else opaque))
    protos.append(nt.SolidPrototype(
        CUBE, nt.Vector(0.5, 0, -2), nt.Matrix.identity(),
        Material((0.4, 0.9, 0.6), opacity=0.5)))
    protos.append(nt.SolidPrototype(
        SPHERE, nt.Vector(-1.5, 0.5, -1), nt.Matrix.identity(),
        Material((0.9, 0.4, 0.6))))
    scene = leaf_scene(nt, protos, 6.0)
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, -8))
    scene.set_camera(camera)
    scene.add_light(nt.PointLight(nt.Vector(0, 4, -4), (1, 0.8, 0.6)))
    scene.set_shadows(True)
    return scene, camera


def solid_orthoplex_scene(nt, material, solid_material, glass=None):
    """The orthoplex {3,...,3,4} of ``nt``'s dimension with a solid beside
    it in the view, in one leaf: without ``glass`` an opaque cube scaled by
    0.35 at (-1.2, 0.8, 0, ...); with it every other simplex is of
    ``glass`` and the solid a sphere of radius 0.4 at (1.3, -0.3, 0, ...)
    of ``solid_material``.  The simplices are single triangles (the oracle
    keeps every glass surface).  Camera, fov and lights as
    ``orthoplex_scene``.  Returns (scene, camera, simplices)."""
    d = nt.dimension
    pts = hull_simplices(polytope_vertices([3] * (d - 2) + [4]))
    # single prototypes, made from the vectorized batch constructor
    protos = list(nt.TrianglePrototype.batch_from_points(
        pts, [glass if glass is not None and i % 2 else material
              for i in range(len(pts))]))
    place = np.zeros(d)
    place[:2] = (1.3, -0.3) if glass is not None else (-1.2, 0.8)
    protos.append(nt.SolidPrototype(
        SPHERE if glass is not None else CUBE, nt.Vector(*place),
        nt.Matrix.scale(0.4 if glass is not None else 0.35),
        solid_material))
    scene = leaf_scene(nt, protos, 2.0)
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, -4.0))
    scene.set_camera(camera)
    scene.set_fov(0.8)
    two_lights(nt, scene, (0, 3, -3, 1) + (0,) * (d - 4))
    return scene, camera, len(pts)


def random_pool(nt, material, n, seed=3):
    """``n`` random simplices of ``nt``'s dimension (lit_scene's spread:
    bases in [-2, 2]^d, vertices within 0.7 of them) under ``two_lights``,
    camera at -8 on axis 2.  Few of them cross the camera's 3-space at
    large d: ``aimed`` makes rays that meet them.  Returns (scene,
    simplices (n, d, d))."""
    d = nt.dimension
    pts = random_simplices(n, d, seed)
    scene = nt.build_composite_scene(
        nt.TrianglePrototype.batch_from_points(pts, [material] * n))
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, -8))
    scene.set_camera(camera)
    two_lights(nt, scene, (0, 3, -3, 1) + (0,) * (d - 4))
    return scene, pts


def aimed(origin, simplices, n, seed=11):
    """(d, n) unit directions from ``origin`` (d,) to seeded points inside
    seeded ``simplices`` (m, d, d): barycentric weights of at least
    1 / (2d), away from the edges."""
    rng = np.random.RandomState(seed)
    m, d, _ = simplices.shape
    w = rng.uniform(1, 2, (n, d))
    w /= w.sum(axis=1, keepdims=True)
    tri = rng.randint(m, size=n)
    v = np.einsum("nk,nkc->nc", w, simplices[tri].astype(np.float64)) \
        - np.asarray(origin, np.float64)
    return np.ascontiguousarray(
        (v / np.linalg.norm(v, axis=1, keepdims=True)).T, np.float32)


def random_simplices(n, d, seed=3):
    """``n`` random simplices of dimension ``d`` (n, d, d): bases in
    [-2, 2]^d, vertices within 0.7 of them (lit_scene's spread)."""
    rng = np.random.RandomState(seed)
    return (rng.uniform(-2, 2, (n, 1, d))
            + rng.uniform(-0.7, 0.7, (n, d, d))).astype(np.float32)


def wide_scene(nt, material, n=200, seed=3, cam_distance=-4.0):
    """The regular simplex of ``nt``'s dimension d (``polytope_vertices([3]
    * (d - 1))``, d + 1 facets: scripts/polytope.py with d - 1 threes) among
    ``n`` random simplices (``random_simplices``), camera at
    ``cam_distance`` on axis 2 turned ``OBLIQUE`` off the axis view, fov
    0.8, under ``two_lights`` with the point light at (0, 3, -3, 1, 0, ...).
    Returns (scene, camera, simplices)."""
    d = nt.dimension
    pts = np.concatenate([hull_simplices(polytope_vertices([3] * (d - 1))),
                          random_simplices(n, d, seed)])
    scene = nt.build_composite_scene(
        nt.TrianglePrototype.batch_from_points(pts, [material] * len(pts)))
    camera = nt.Camera()
    turn(nt, scene, camera, cam_distance, OBLIQUE)
    scene.set_fov(0.8)
    two_lights(nt, scene, (0, 3, -3, 1) + (0,) * (d - 4))
    return scene, camera, len(pts)


def simplex_rows(pts):
    """The per-triangle rows of simplices ``pts`` (n, d, d) that
    ``flatten`` takes from their prototypes -- p1, the face normal fn (the
    edges' cross product), the edge normals en (n, d - 1, d), with
    en_i . (p1 - x) the barycentric coordinate i of x, dc = -fn . p1, and the
    vertex box lo/hi -- without a scene.  Computed in float64 and rounded
    to float32: the prototypes' rows to within rounding (the prototypes'
    float32 cofactors run Python loops that grow as d^5, a scene's k-d
    build faster still)."""
    pts = np.asarray(pts, np.float64)
    n, d, _ = pts.shape
    p1 = pts[:, 0]
    edges = pts[:, 1:] - p1[:, None]                     # (n, d - 1, d)
    fn = np.empty((n, d))
    for k in range(d):
        minor = np.delete(edges, k, axis=2)               # (n, d - 1, d - 1)
        fn[:, k] = (-1.0) ** (k + d + 1) * np.linalg.det(minor)
    # -en_i is column i of the inverse of the rows [edges; fn]: en_i . e_j
    # = -[i == j], en_i . fn = 0
    inv = np.linalg.inv(np.concatenate([edges, fn[:, None]], axis=1))
    en = -inv[:, :, :d - 1].transpose(0, 2, 1)
    f32 = np.float32
    return dict(p1=p1.astype(f32), fn=fn.astype(f32), en=en.astype(f32),
                dc=(-np.einsum("nd,nd->n", fn, p1)).astype(f32),
                lo=pts.min(axis=1).astype(f32), hi=pts.max(axis=1).astype(f32))


def simplex_pool(pts, dev):
    """The grid walks' pool of simplices ``pts`` (n, d, d), in their order,
    straight from their rows (``simplex_rows``) with no scene: the device
    scene's ``kern_*`` arrays (``grid_kernels.prepare_tri_arrays``, padded
    to whole 512-triangle tiles) and the plane records ``kern_grec``."""
    from ntracer_tpu_torch.engine import grid_kernels as gk
    rows = simplex_rows(pts)
    n, d = rows["p1"].shape
    T = -(-n // gk.TRI_BLOCK) * gk.TRI_BLOCK

    def pad(a):
        return np.concatenate([a, np.zeros((T - n,) + a.shape[1:], a.dtype)])

    kern = gk.prepare_tri_arrays(*(pad(rows[k]) for k in
                                   ("p1", "fn", "en", "dc", "lo", "hi")), d)
    arrs = {"kern_" + short: torch.from_numpy(kern[k]).to(dev)
            for k, short in (("gt", "gt"), ("ci", "ci"), ("k_lo", "klo"),
                             ("k_hi", "khi"), ("k_any", "kany"),
                             ("b_lo", "blo"), ("b_hi", "bhi"))}
    arrs["kern_grec"] = gk.plane_records(arrs["kern_gt"], d)
    return arrs


def mesh_d3_scene(nt, material, n, seed=3):
    """scripts/tpu_parity.py's 3-D meshes: ``n`` random triangles of one
    material, its two lights, shadows on ("shadows d=3": 700 opaque ones;
    "transparent d=3": 500 of glass).  Returns the scene."""
    rng = np.random.RandomState(seed)
    protos = []
    for _ in range(n):
        base = rng.uniform(-2, 2, 3)
        pts = [nt.Vector(*(base + rng.uniform(-0.7, 0.7, 3)))
               for _ in range(3)]
        protos.append(nt.TrianglePrototype(pts, material))
    scene = nt.build_composite_scene(protos)
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, -8))
    scene.set_camera(camera)
    return two_lights(nt, scene, (0, 5, 0))


def sphere_mesh(n_target):
    """Lat/long tessellated unit sphere with ~n_target triangles (the mesh
    of scripts/bench_mesh.py).  Degenerate triangles are dropped, the polar
    rings with them: the sphere has a small hole at each pole."""
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


def mesh_scene(nt, protos):
    """A mesh seen from scripts/bench_mesh.py's camera, under
    tpu_parity.py's two lights (the point light at (0, 5, 0)), shadows on.
    Returns (scene, camera)."""
    scene = nt.build_composite_scene(protos)
    camera = nt.Camera()
    camera.translate(nt.Vector(0, 0, MESH_DISTANCE))
    scene.set_camera(camera)
    two_lights(nt, scene, (0, 5, 0))
    return scene, camera


class unbatched:
    """Build scenes without grouping triangles into batches.  The scalar
    oracle records one transparent hit per batch per leaf, the engine keeps
    every transparent surface: only an unbatched scene's oracle means what
    the engine renders."""

    def __init__(self, kdtree):
        self.kdtree = kdtree

    def __enter__(self):
        self.saved = self.kdtree.group_primitives
        self.kdtree.group_primitives = lambda prims: list(prims)

    def __exit__(self, *exc):
        self.kdtree.group_primitives = self.saved


def time_cuda(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def timed(fn):
    """Run ``fn`` once: (its result, ms on the host clock around it, the
    card synchronized on both sides).  For the twins on the mesh, whose
    one call takes seconds."""
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1000 * (time.perf_counter() - t1)


def div_sass_ops(build_dir, nvcc, flags):
    """Instructions that div.rn.f32 executes on its fast path: the SASS
    instructions a kernel ``a[i] = a[i] / b[i]`` executes from its entry to its
    first EXIT, taking each predicated branch (the range check's branch
    around the slow-path call), less those of ``a[i] = a[i] * b[i]``, plus
    the multiply it replaces.  Returns the count and the division kernel's
    executed instructions."""
    src = os.path.join(build_dir, "div_probe.cu")
    cubin = os.path.join(build_dir, "div_probe.cubin")
    with open(src, "w") as f:
        f.write(DIV_PROBE)
    subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, src], check=True,
                   capture_output=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    executed = {}
    for part in sass.split("Function : ")[1:]:
        code = {}
        for line in part.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4})\*/\s+(.*?)\s*;", line)
            if m:
                code[int(m.group(1), 16)] = m.group(2)
        addrs = sorted(code)
        run, i = [], 0
        while i < len(addrs):
            text = code[addrs[i]]
            run.append(text)
            if text.startswith("EXIT"):
                break
            jump = re.match(r"@!?U?P\d+ BRA (0x[0-9a-f]+)", text)
            i = addrs.index(int(jump.group(1), 16)) if jump else i + 1
        executed[part.split()[0]] = run
    div, mul = executed["ntr_div_probe"], executed["ntr_mul_probe"]
    return len(div) - len(mul) + 1, div


def pair_ops(d, shared):
    """Float32 instructions each stage of a pair test costs, as a list:
    [the plane-0 dots and numerator, the division, edge 1, ..., edge d-1].

    A dot of d products is d multiplies and d - 1 adds (the sum starts at
    its first product).  Every pair pays the dots of plane 0 -- the
    direction's, and unless the origin dots are shared (primary rays) the
    origin's -- and the numerator's subtraction.  A pair whose numerator and
    denominator are not both nonzero and of one sign cannot have t > 0, so
    only the others pay the division, at ``DIV_OPS``.  A pair with t in
    range pays edge 1: its dots, ``(c - o.n) - t * (d.n)`` (shared: ``c - t
    * (d.n)``); later edges add the running total's add, and only a pair
    that passed every edge before pays an edge."""
    dot = 2 * d - 1
    base = dot if shared else 2 * dot + 1
    edge = dot + 2 if shared else 2 * dot + 3
    return [base, DIV_OPS] + [edge + (i > 1) for i in range(1, d)]


def walk_bound(d, shared, need, read, stages, chunks, pool_bytes,
               mask_bytes, out_bytes, early=None):
    """The least time (ms) the card could take for one walk on this run's
    data, and which bound it is: the larger of bytes over the memory rate
    and operations over the float32 rate.

    ``need`` (R,) bool marks the rays that can still be decided by a pair
    test (active, and for the nearest-hit walk inside the pool's box);
    ``read`` (R,) bool the rays whose origin and direction the function
    must look at to know that; ``stages`` (d + 1 counts, ``walk_stages``)
    the pair tests of the needed rays in their blocks' visits that reach
    each stage of ``pair_ops`` (a decided ray needs none); ``early`` (R,)
    bool marks needed rays that one pair test decides (a shadow ray that
    ends blocked: its first hit ends its walk), which count one whole pair
    test each and are left out of ``stages``.  The transparent walks count
    the same way: the K-slot walk's needed rays are the active rays inside
    the box (a ray can collect glass hits as long as its block walks), its
    ``pool_bytes`` include the opacity row and its ``out_bytes`` the K
    slots; in the filtered occlusion walk a ray is decided only when it
    ends blocked, and the filter adds no operation worth counting (a
    multiply for each glass surface a ray really crosses, a handful; the
    factor 1 of every other slot need not be multiplied).

    Bytes: origin, direction and skip id of every 512-ray block that has a
    ray to read, ``mask_bytes`` per ray of the whole wavefront (the mask or
    distance that says which rays are active), the pool's rows and boxes
    once, every output once.  Operations are float32 instructions, over
    ``PEAK_FP32``, the card's rate without contraction (the kernels are
    built with --fmad=false: a multiply and an add are two instructions):
    the slab entries of the needed rays into every chunk box (4 per axis),
    and each stage of the pair tests at its ``pair_ops`` cost.  The division
    counts ``DIV_OPS`` = 10 instructions, what its fast path executes in
    the H100's SASS from nvcc 12.8 (``div_sass_ops``: MUFU.RCP, FCHK, five
    FFMA, the branch around the slow-path call and its BSSY/BSYNC).  The
    grid walks (kernels 2.9 and 2.10) count the same way, a tile of 512
    triangles for a chunk of 128 slots: ``chunks`` is then the pool's tiles
    (the slab entries of the needed rays into every tile's box)."""
    rays = need.numel()
    read_blocks = int(read.reshape(-1, 512).any(dim=1).sum())
    in_bytes = read_blocks * 512 * (2 * d * 4 + 4) + rays * mask_bytes \
        + pool_bytes
    bytes_ms = 1e3 * (in_bytes + out_bytes) / PEAK_BYTES
    costs = pair_ops(d, shared)
    ops = sum(int(n) * c for n, c in zip(stages, costs, strict=True))
    if early is not None:
        ops += int((need & early).sum()) * sum(costs)
    ops += int(need.sum()) * chunks * 4 * d
    ops_ms = 1e3 * ops / PEAK_FP32
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms \
        else (ops_ms, "operations")


def staged_pairs(d, shared, g, ci, idrow, o, dv, skip, charged, cut):
    """The pair test of ``n`` ray blocks, each against its own chunk (or
    one tile), with the twins' float operations: (t, valid), (n, 512, L),
    bit for bit ``resident_kernels._chunk_hits_vals``'s.  Also the counts
    (d + 1,) of the ``charged`` (n, 512) rays' pairs that reach each stage of
    ``pair_ops``: all but the ray's own skip id; those whose numerator and
    denominator are nonzero and of one sign (the division); those with
    0 < t < ``cut`` (n, 512, 1 or L) (edge 1); those that passed edges
    1 .. i - 1 (edge i).  ``g`` (n or 1, pr, L), ``ci`` (n or 1, rows, L),
    ``idrow`` (n or 1, L), ``o``/``dv`` (d, n, 512, 1), ``skip`` (n, 512, 1).
    """
    from ntracer_tpu_torch.engine import resident_kernels as rk
    zeros = torch.zeros((1,), dtype=torch.float32, device=g.device)

    def dots(p):
        acc_o = None if shared else zeros
        acc_d = zeros
        for c in range(d):
            row = g[:, None, p * d + c, :]
            if not shared:
                acc_o = acc_o + o[c] * row
            acc_d = acc_d + dv[c] * row
        return acc_o, acc_d

    o0, dn = dots(0)
    num = ci[:, None, 0, :] if shared else ci[:, None, 0, :] - o0
    t = num / dn
    own = idrow[:, None, :] != skip
    valid = (dn != 0) & (t > 0) & own
    base = charged[:, :, None] & own
    pre = base & (((num > 0) & (dn > 0)) | ((num < 0) & (dn < 0)))
    reach = pre & (t > 0) & (t < cut)
    counts = [base.sum(), pre.sum(), reach.sum()]
    tot = zeros
    for i in range(1, d):
        oi, di = dots(i)
        a = ci[:, None, i, :] - t * di if shared \
            else ci[:, None, i, :] - oi - t * di
        ok = (a >= -rk.ROUNDING_FUZZ) & (a <= rk.ONE_FUZZ)
        valid &= ok
        tot = tot + a
        if i < d - 1:
            reach &= ok
            counts.append(reach.sum())
    valid &= tot <= rk.ONE_FUZZ
    return t, valid, torch.stack(counts)


def walk_stages(w, charged, cut, visits):
    """Replay a walk's visits with the twins' rule and count, over the
    pairs of the ``charged`` (R,) rays in their blocks' visits, the pair
    tests that reach each stage (``staged_pairs``, ``cut`` (R,) the t a
    pair must stay below to matter).  ``w`` is a walk's inputs:
    ``resident_kernels._occlusion_inputs`` (an occlusion walk; with an
    opacity row the filtered one), ``_walk_inputs`` (a nearest-hit walk; in
    the K-slot walk a glass slot's pair matters at any t, since the slots
    are not trimmed by the nearest hit) or ``grid_kernels._grid_inputs``
    (the grid walks).  Raises SystemExit unless the replay's visits equal
    ``visits``, the kernel's.  Returns (stages (d + 1,) list, the pair
    tests an occlusion walk deals out: the undecided rays at each group's
    start x 128 slots, for each visit of the group)."""
    from ntracer_tpu_torch.engine import resident_kernels as rk
    grid = "k_any" in w
    occl = "ldist" in w
    d = w["d"]
    dev = w["oT"].device
    RB = rk.RAY_BLOCK
    width = 512 if grid else rk.CK
    nb_all = w["oT"].shape[1] // RB
    stages = torch.zeros((d + 1,), dtype=torch.int64, device=dev)
    dealt = torch.zeros((), dtype=torch.int64, device=dev)
    got = []
    step = rk._twin_step(width, dev.type)
    inf = float(rk.INF)
    for b0 in range(0, nb_all, step):
        b1 = min(nb_all, b0 + step)
        nb, sl = b1 - b0, slice(b0 * RB, b1 * RB)
        o = w["oT"][:, sl].reshape(d, nb, RB, 1)
        dv = w["dT"][:, sl].reshape(d, nb, RB, 1)
        skip = w["skip"][sl].reshape(nb, RB, 1)
        chg = charged[sl].reshape(nb, RB)
        ct = cut[sl].reshape(nb, RB, 1)
        vis = torch.zeros((nb,), dtype=torch.int32, device=dev)
        if occl:
            ldist = w["ldist"][sl].reshape(nb, RB)
            blocked = torch.zeros((nb, RB), dtype=torch.bool, device=dev)
        else:
            best = w["init_t"][sl].reshape(nb, RB).clone()

        def visit(sel, g, ci, idrow, opa):
            slot_cut = ct[sel]
            if opa is not None and not occl:
                slot_cut = torch.where(opa >= 1.0, slot_cut, inf)
            t, valid, cnt = staged_pairs(
                d, w.get("shared", False), g, ci, idrow, o[:, sel],
                dv[:, sel], skip[sel], chg[sel], slot_cut)
            stages.add_(cnt)
            if opa is not None:
                valid &= opa >= 1.0
            if occl:
                valid &= t < ldist[sel][:, :, None]
                blocked[sel] |= torch.any(valid, dim=2)
            else:
                c_t = torch.amin(torch.where(valid, t, inf), dim=2)
                best[sel] = torch.where(c_t < best[sel], c_t, best[sel])
            vis[sel] += 1

        if grid:
            k_lo_t = w["k_lo"][:, 0, :].T
            k_hi_t = w["k_hi"][:, 0, :].T
            entries = rk._entry_all(d, o, dv, k_lo_t, k_hi_t,
                                    k_lo_t.shape[1])
            for j, any_j in enumerate(w["k_any"].reshape(-1).tolist()):
                if any_j == 0:
                    continue
                entry = entries[:, :, j]
                run = torch.any((entry < ldist) & ~blocked, dim=1) if occl \
                    else torch.any(entry < best, dim=1)
                sel = torch.nonzero(run).squeeze(1)
                if sel.numel():
                    cols = slice(j * 512, (j + 1) * 512)
                    ids = j * 512 + torch.arange(512, device=dev)
                    visit(sel, w["gt"][None, :, cols], w["ci"][None, :, cols],
                          ids[None], None)
            got.append(vis)
            continue
        n = w["n_eff"]
        if n == 0:
            got.append(vis)
            continue

        def bound():
            if occl:
                return torch.amax(torch.where(blocked, 0.0, ldist), dim=1)
            return torch.amax(best, dim=1)

        p = 1 if w.get("K") and not w.get("grouped") else rk.P_CAND
        emin = rk._entry_minima(w, o, dv)
        order = w["order"].long()
        none = torch.full((nb,), n, dtype=torch.int64, device=dev)
        cur = rk._find_cands(emin, bound(), torch.zeros_like(none), n, p)
        cur[w["blive"][b0:b1] == 0] = rk.SENT
        while bool((cur[:, 0] < rk.SENT).any()):
            k0 = torch.where(cur[:, -1] < rk.SENT, cur[:, -1] + 1, none)
            nxt = rk._find_cands(emin, bound(), k0, n, p)
            if occl:
                und = (~blocked & (ldist > 0)).sum(dim=1)
                dealt += (und * (cur < rk.SENT).sum(dim=1)).sum() * rk.CK
            for j in range(p):
                sel = torch.nonzero(cur[:, j] < rk.SENT).squeeze(1)
                if sel.numel() == 0:
                    continue
                idx = order[cur[sel, j]]
                opa = None if w.get("opa") is None \
                    else w["opa"][idx, 0][:, None, :]
                visit(sel, w["gt"][idx], w["ci"][idx], w["ids"][idx, 0], opa)
            cur = nxt
        got.append(vis)
    got = torch.cat(got)
    if not torch.equal(got, visits.to(got.dtype)):
        raise SystemExit(f"the bound's replay visits differently from the "
                         f"kernel in {int((got != visits).sum())} blocks")
    return stages.tolist(), int(dealt)


def next_up(t):
    """The next float above each of ``t``: a pair at the nearest hit's t
    or nearer matters."""
    return torch.nextafter(t, torch.full_like(t, float("inf")))


def stage_note(stages):
    """The pair tests the bound counts, and the share of them that reaches
    each later stage of ``pair_ops``."""
    n = max(stages[0], 1)
    rest = ", ".join(f"edge {i} {100 * c / n:.2f}%"
                     for i, c in enumerate(stages[2:], 1))
    return (f"bound's pair tests {stages[0]}: division "
            f"{100 * stages[1] / n:.2f}%, {rest}")


def nearest_stages(res, o, dv, skip, d, kw, t, visits, K=0, grouped=False):
    """``walk_stages`` of a nearest-hit walk over a chunked pool (``kw`` its
    call's keywords, ``t`` and ``visits`` its outputs): the needed rays, a
    pair mattering up to the ray's nearest hit."""
    from ntracer_tpu_torch.engine import resident_kernels as rk
    w = rk._walk_inputs(res, o, dv, skip, d, kw.get("order"),
                        kw.get("active"), kw.get("sh"), K=K)
    w["grouped"] = grouped
    return walk_stages(w, w["init_t"] > 0, next_up(t), visits)[0]


def occlusion_stages(res, o, dv, ldist, skip, d, blocked, visits,
                     filtered=False):
    """``walk_stages`` of an occlusion walk over a chunked pool: the active
    rays that end unblocked, a pair mattering below ``ldist``.  Returns
    (stages, pair tests dealt out)."""
    from ntracer_tpu_torch.engine import resident_kernels as rk
    w = rk._occlusion_inputs(res, o, dv, ldist, skip, d, None,
                             filtered=filtered)
    return walk_stages(w, (ldist > 0) & ~blocked, ldist, visits)


def grid_walk_stages(kern, o, dv, skip, d, visits, sh=None, t=None,
                     ldist=None, blocked=None):
    """``walk_stages`` of a grid walk: the nearest-hit walk's (``t``) or,
    with ``ldist`` and ``blocked``, the occlusion walk's."""
    from ntracer_tpu_torch.engine import grid_kernels as gk
    w = gk._grid_inputs(kern, o, dv, skip, d, sh=sh, ldist=ldist)
    if ldist is None:
        return walk_stages(w, w["init_t"] > 0, next_up(t), visits)[0]
    return walk_stages(w, (ldist > 0) & ~blocked, ldist, visits)[0]


def grid_shadow_rays(hit, light_pos=None, light_dir=None):
    """Shadow rays of a d > 8 frame as the engine casts them: from the
    primary hits (misses inactive) away from the point light at
    ``light_pos`` (ldist its distance), or towards the global light
    ``light_dir`` (ldist REAL_MAX, unclamped).  -> (origins, directions,
    ldist)."""
    from ntracer_tpu_torch.engine import resident_kernels as rk
    from ntracer_tpu_torch.engine import wavefront as wf
    point = torch.where(hit["hit"][None, :], hit["pointT"], 0.0)
    if light_pos is not None:
        lv = point - light_pos[:, None]
        dist = rk._sqrt(wf._dotT(lv, lv))
        return point, (lv / dist[None, :]).contiguous(), \
            torch.where(hit["hit"], dist, 0.0)
    ld = (-light_dir)[:, None].expand_as(point).contiguous()
    return point, ld, torch.where(hit["hit"], wf.REAL_MAX, 0.0)


def pool_bytes(arrs, opacity=False):
    """Bytes of the pool's rows and boxes; with ``opacity`` the row of
    opacities the transparent walks read (row 0 of ``res_opa``)."""
    return sum(arrs[k].numel() * 4 for k in
               ("res_gt", "res_ci", "res_ids", "res_klo", "res_khi",
                "res_order")) \
        + (arrs["res_opa"][:, 0].numel() * 4 if opacity else 0)


def grid_pool_bytes(arrs):
    """Bytes of a grid pool's rows and tile boxes (the shared rows of a
    primary trace replace ``ci`` and have its size)."""
    return sum(arrs[k].numel() * 4 for k in
               ("kern_gt", "kern_ci", "kern_klo", "kern_khi", "kern_kany"))


def turn(nt, scene, camera, cam_distance, angle):
    """Turn the camera by ``angle`` about the scene's centre, in the plane
    of its view axis and the diagonal of its other axes (the rotation of
    scripts/bench_suite.py's orbit)."""
    d = nt.dimension
    hcoef = 1 / math.sqrt(d - 1)
    a2 = camera.axes[0] * hcoef + camera.axes[1] * hcoef
    for i in range(3, d):
        a2 = a2 + camera.axes[i] * hcoef
    camera.transform(nt.Matrix.rotation(camera.axes[2], a2, angle))
    camera.normalize()
    camera.origin = camera.axes[2] * cam_distance
    scene.set_camera(camera)


def orbit(nt, scene, camera, cam_distance, frames, renderer, buf, fmt):
    """Render a warm-up frame and ``frames`` frames of a camera orbit;
    returns the frames' seconds."""
    incr = 2 * math.pi / frames
    if not renderer.render(buf, fmt, scene):       # warm-up
        raise SystemExit("warm-up render was aborted")
    turn(nt, scene, camera, cam_distance, incr)
    frame_s = []
    for _ in range(frames):
        t1 = time.perf_counter()
        if not renderer.render(buf, fmt, scene):
            raise SystemExit("render was aborted")
        frame_s.append(time.perf_counter() - t1)
        turn(nt, scene, camera, cam_distance, incr)
    return frame_s


def report_frames(label, frame_s, buf, name_limit):
    px = np.frombuffer(bytes(buf), np.uint8).reshape(H, W, 3)
    print(f"   last frame: {int((px.max(axis=2) > 0).sum())} lit pixels, "
          f"mean byte {px.mean():.3f}")
    if px.max() == 0:
        raise SystemExit(f"the {label} frame is black")
    ms = 1000 * float(np.median(frame_s))
    print(f"   {label} frame: median {ms:.3f} ms/frame, "
          f"{W * H / (ms / 1000) / 1e6:.3f} Mrays/s, min "
          f"{1000 * min(frame_s):.3f} max {1000 * max(frame_s):.3f} ms over "
          f"{len(frame_s)} orbit frames (host clock around render(), pull "
          f"included) [{name_limit}]")


def callback_frame(crenderer, scene, fmt):
    """One frame of ``scene`` through ``crenderer``: its buffer."""
    buf = bytearray(fmt.pitch * fmt.height)
    called = threading.Event()
    crenderer.begin_render(buf, fmt, scene, lambda _r: called.set())
    if not called.wait(timeout=600):
        raise SystemExit("a callback frame never called back")
    return buf


def callback_orbit(nt, scene, cam_distance, renderer, crenderer, fmt):
    """The orbit of CALLBACK_FRAMES frames through the blocking renderer
    (the reference bytes) and through ``crenderer``, the camera turned
    right after each begin_render: once with every frame in flight at once
    (the first callback waits until all are dispatched; its launches are
    the path's), then CALLBACK_ROUNDS timed rounds of both loops in turns
    (blocking, pipelined, pipelined, blocking, ...), the pipelined one with
    CALLBACK_DEPTH buffers.  Every run's bytes must equal the reference's,
    called back in FIFO order.  Returns (launches of the first callback
    run, begin_render's ms, pipelined and blocking frames/s of each round,
    most frames seen in flight in the timed runs)."""
    incr = 2 * math.pi / CALLBACK_FRAMES
    start = scene.get_camera()
    want = []
    camera = scene.get_camera()
    buf = bytearray(fmt.pitch * fmt.height)
    for _ in range(CALLBACK_FRAMES):
        if not renderer.render(buf, fmt, scene):
            raise SystemExit("render was aborted")
        want.append(bytes(buf))
        turn(nt, scene, camera, cam_distance, incr)
    callback_frame(crenderer, scene, fmt)    # warm-up: worker, pinned pool

    def check(out, order):
        if order != list(range(len(out))):
            raise SystemExit(f"callbacks out of order: {order}")
        bad = [k for k, b in enumerate(out) if bytes(b) != want[k]]
        if bad:
            raise SystemExit(f"frames {bad} differ from the blocking "
                             f"renderer's first frames")

    def blocking():
        scene.set_camera(start)
        camera = scene.get_camera()
        out = [bytearray(fmt.pitch * fmt.height) for _ in want]
        t1 = time.perf_counter()
        for b in out:
            if not renderer.render(b, fmt, scene):
                raise SystemExit("render was aborted")
            turn(nt, scene, camera, cam_distance, incr)
        seconds = time.perf_counter() - t1
        check(out, list(range(len(out))))
        return seconds

    def pipelined(depth, hold):
        scene.set_camera(start)
        camera = scene.get_camera()
        out = [bytearray(fmt.pitch * fmt.height) for _ in want]
        slots = threading.Semaphore(depth)
        dispatched = threading.Event()
        order = []
        all_done = threading.Event()
        begin_ms, most = [], 0

        def called(k):
            def cb(_r):
                if hold and k == 0:
                    dispatched.wait(timeout=600)
                order.append(k)
                slots.release()
                if len(order) == len(out):
                    all_done.set()
            return cb

        t1 = time.perf_counter()
        for k, b in enumerate(out):
            if not slots.acquire(timeout=600):
                raise SystemExit("the callback queue stalled")
            t2 = time.perf_counter()
            crenderer.begin_render(b, fmt, scene, called(k))
            begin_ms.append(1000 * (time.perf_counter() - t2))
            most = max(most, crenderer._jobs)
            turn(nt, scene, camera, cam_distance, incr)
        dispatched.set()
        if not all_done.wait(timeout=600):
            raise SystemExit(f"{len(order)} of {len(out)} callbacks fired")
        seconds = time.perf_counter() - t1
        check(out, order)
        return seconds, begin_ms, most

    reset_launches()
    _s, _ms, held = pipelined(CALLBACK_FRAMES, hold=True)
    launches = read_launches()
    if held < CALLBACK_FRAMES:
        raise SystemExit(f"only {held} frames were in flight")
    begin_ms, fps, blocking_fps, most = [], [], [], 0
    for r in range(CALLBACK_ROUNDS):
        for kind in (("blocking", "pipelined") if r % 2 == 0 else
                     ("pipelined", "blocking")):
            if kind == "blocking":
                blocking_fps.append(CALLBACK_FRAMES / blocking())
                continue
            seconds, ms, n = pipelined(CALLBACK_DEPTH, hold=False)
            fps.append(CALLBACK_FRAMES / seconds)
            begin_ms += ms
            most = max(most, n)
    print(f"   {CALLBACK_FRAMES} orbit frames through CallbackRenderer, "
          f"{held} in flight at once, then {CALLBACK_ROUNDS} timed rounds "
          f"with {CALLBACK_DEPTH} buffers in turns with the blocking loop: "
          f"bytes equal BlockingRenderer's, callbacks in FIFO order")
    scene.set_camera(start)
    return launches, begin_ms, fps, blocking_fps, most


def front_end(nt, scene, cam_distance, lit, renderer, fmt, dev,
              name_limit):
    """The renderer front end on the card (phase "callback renderer"):
    ``callback_orbit`` on ``scene``, begin_render's return time, the
    pipelined and the blocking frame rates and the device frame time; an
    abort with frames queued; ``lit`` through CallbackRenderer (kernel 2.2
    behind it); a 30/30/4 format through both renderers; a 32-row strip
    at y0 = 500 on the card against the CPU's.  Returns the launches of
    the callback orbit."""
    import ntracer_tpu_torch as nt_torch
    from ntracer_tpu_torch import ImageFormat, Channel
    from ntracer_tpu_torch.engine import wavefront as wf
    w, h = fmt.width, fmt.height
    crenderer = nt_torch.CallbackRenderer(device=dev)
    launches, begin_ms, fps, blocking_fps, most = callback_orbit(
        nt, scene, cam_distance, renderer, crenderer, fmt)
    print(f"   launches in the {CALLBACK_FRAMES} callback renders in "
          f"flight: {json.dumps(launches)}")
    if launches["nearest_hit"] < CALLBACK_FRAMES:
        raise SystemExit("the callback renderer did not go through "
                         "nearest_hit")
    device_ms = time_cuda(
        lambda: wf.frame_device_arrays(scene, fmt, dev), 5)
    print(f"   begin_render returns in {float(np.median(begin_ms)):.3f} ms "
          f"(median of {len(begin_ms)}, min {min(begin_ms):.3f} max "
          f"{max(begin_ms):.3f}); pipelined {float(np.median(fps)):.3f} "
          f"frames/s (median of {len(fps)} rounds "
          f"{[round(x, 3) for x in fps]}, {CALLBACK_DEPTH} buffers, at most "
          f"{most} frames in flight) against the blocking loop's "
          f"{float(np.median(blocking_fps)):.3f} "
          f"({[round(x, 3) for x in blocking_fps]}); device frame "
          f"{device_ms:.4f} ms (CUDA events around frame_device_arrays) "
          f"[{name_limit}]")

    # abort with frames queued: no callback after abort_render returns
    calls = []

    def slow(_r):
        time.sleep(0.2)
        calls.append(1)

    bufs = [bytearray(fmt.pitch * h) for _ in range(4)]
    crenderer.begin_render(bufs[0], fmt, scene, slow)
    for buf in bufs[1:]:
        crenderer.begin_render(buf, fmt, scene, lambda _r: calls.append(1))
    crenderer.abort_render()
    n_calls = len(calls)
    time.sleep(0.5)
    print(f"   abort with 4 frames queued: {n_calls} callback(s) before "
          f"abort_render returned, {len(calls) - n_calls} after")
    if len(calls) != n_calls or crenderer._jobs:
        raise SystemExit("a callback fired after abort_render returned")

    # lit_config through CallbackRenderer: kernel 2.2 behind it
    lbuf = bytearray(fmt.pitch * h)
    if not renderer.render(lbuf, fmt, lit):
        raise SystemExit("render was aborted")
    reset_launches()
    cbuf = callback_frame(crenderer, lit, fmt)
    lit_launches = read_launches()
    print(f"   lit_config through CallbackRenderer: launches "
          f"{json.dumps(lit_launches)}, bytes equal BlockingRenderer's: "
          f"{cbuf == lbuf}")
    if cbuf != lbuf or lit_launches["occluded"] < 3:
        raise SystemExit("the lit callback frame differs or skipped 2.2")

    # 30/30/4: float colors from the card, packed exactly on the host
    wide = ImageFormat(w, h, [Channel(30, 1, 0, 0), Channel(30, 0, 1, 0),
                              Channel(4, 0, 0, 1)])
    packs = {"pack_device_stream": 0, "pack_flat": 0}

    def counted(fn, name):
        def count(*a, **k):
            packs[name] += 1
            return fn(*a, **k)
        return count

    real = {n: getattr(wf.packing, n) for n in packs}
    for n in packs:
        setattr(wf.packing, n, counted(real[n], n))
    try:
        wbuf = bytearray(wide.pitch * h)
        t1 = time.perf_counter()
        if not renderer.render(wbuf, wide, scene):
            raise SystemExit("render was aborted")
        wide_ms = 1000 * (time.perf_counter() - t1)
        wcbuf = callback_frame(crenderer, scene, wide)
    finally:
        for n in packs:
            setattr(wf.packing, n, real[n])
    expect = wf.packing.pack_rows(wf.frame_colors(scene, w, h, dev),
                                  wide).tobytes()
    print(f"   30/30/4 frame: blocking {wide_ms:.3f} ms (host clock, pull "
          f"and host packing included), packers called {json.dumps(packs)}; "
          f"bytes equal pack_rows of the card's colors: blocking "
          f"{bytes(wbuf) == expect}, callback {bytes(wcbuf) == expect} "
          f"[{name_limit}]")
    if bytes(wbuf) != expect or bytes(wcbuf) != expect or \
            packs["pack_device_stream"] or not packs["pack_flat"]:
        raise SystemExit("the wide-channel frame is not the exact packer's")

    # a strip on the card against the same strip on the CPU
    t1 = time.perf_counter()
    strip = scene._render_strip(fmt, 500, 32, device=dev)
    t2 = time.perf_counter()
    strip_cpu = scene._render_strip(fmt, 500, 32, device="cpu")
    err = float(np.abs(strip - strip_cpu).max())
    print(f"   strip of 32 rows at y0 = 500: card {1000 * (t2 - t1):.3f} ms "
          f"(first strip of the scene), CPU {time.perf_counter() - t2:.2f} "
          f"s, max abs diff {err:.3e}, "
          f"{int((strip.max(axis=2) > 0).sum())} lit pixels")
    if strip.shape != (32, w, 3) or not np.allclose(strip, strip_cpu,
                                                    rtol=2e-6, atol=2e-7):
        raise SystemExit("the card's strip differs from the CPU's")
    return launches


def apps(size, name_limit):
    """scripts/polytope.py (the 120-cell) and scripts/hypercube.py (a 4-D
    BoxScene) unmodified, APP_FRAMES frames of ``size`` each, through
    ``python -m ntracer_tpu_torch.alias`` on the card (phase "apps")."""
    for app in (["scripts/polytope.py", "5", "3", "3", "--benchmark", "-s",
                 size, "-f", str(APP_FRAMES)],
                ["scripts/hypercube.py", "-d", "4", "--benchmark", "-s",
                 size, "-f2", str(APP_FRAMES)]):
        t1 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "ntracer_tpu_torch.alias", *app],
            cwd=REPO, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, SDL_VIDEODRIVER="dummy"))
        print(f"   {' '.join(app)}: exit {run.returncode} in "
              f"{time.perf_counter() - t1:.2f} s")
        for line in run.stdout.strip().splitlines()[-3:]:
            print(f"      {line} [{name_limit}]")
        if run.returncode or f"rendered {APP_FRAMES} frame(s)" not in \
                run.stdout:
            print(run.stderr[-2000:])
            raise SystemExit(f"{app[0]} failed on the port")


def shard_walks(run):
    """Run ``run()`` and count the pool walks (traces and shadow queries,
    ``wavefront._trace_walk`` and ``_occlusion_walk``) of each prim shard,
    by the shard's index, with the walks' counters of that shard
    (``frame_stats``' keys, the walks' own stats argument): {shard:
    {"trace": n, "shadow": n, "chunks_visited": n, ...}}."""
    from ntracer_tpu_torch.engine import wavefront as wf
    counts = {}
    trace_walk, occlusion_walk = wf._trace_walk, wf._occlusion_walk

    def counting(fn, kind):
        def walk(arrs, *a):
            j = int(arrs["tri_base"]) // arrs.get("shard_rows", 1)
            c = counts.setdefault(j, {"trace": 0, "shadow": 0})
            c[kind] += 1
            # the last argument is the walk's stats dict
            return fn(arrs, *a[:-1], c)
        return walk

    wf._trace_walk = counting(trace_walk, "trace")
    wf._occlusion_walk = counting(occlusion_walk, "shadow")
    try:
        out = run()
    finally:
        wf._trace_walk, wf._occlusion_walk = trace_walk, occlusion_walk
    return out, {j: {k: int(v) for k, v in c.items()}
                 for j, c in counts.items()}


def shard_kind(arrs):
    """Which walks a pool (or a prim shard) takes, and its layout's size."""
    from ntracer_tpu_torch.engine import resident_kernels as rk
    from ntracer_tpu_torch.engine import wavefront as wf
    if wf._grid(arrs):
        return f"grid walks 2.9/2.10, {arrs['kern_gt'].shape[1]} triangles"
    if wf._scan(arrs):
        return f"chunk scan, {arrs['tri_pack'].shape[0]} triangles"
    n = arrs["res_klo"].shape[0]
    mib = rk.pool_bytes(n * rk.CK, arrs["res_klo"].shape[-1]) / 2 ** 20
    walks = "streaming walks 2.5-2.8" if wf._streams(arrs) \
        else "walks 2.1-2.4"
    return f"{walks}, {n} chunks, {mib:.1f} MiB"


def byte_diffs(a, b, fmt):
    """(bytes that differ, most codes apart) of two (H, W, 3) float frames
    packed to ``fmt``."""
    from ntracer_tpu_torch.engine import packing
    pa = packing.pack_flat(a.reshape(-1, 3), fmt).astype(int)
    pb = packing.pack_flat(b.reshape(-1, 3), fmt).astype(int)
    return int((pa != pb).sum()), int(np.abs(pa - pb).max())


def multi_device(flagship, paths, renderer, fmt, dev, name_limit, launches,
                 reps=3):
    """The sharded paths on one card (phase "multi-device"): a mesh there is
    several shards on ``dev`` (``make_mesh(..., devices=[dev] * n)``).

    The flagship's frame split over a px mesh of four through the renderer
    (``wavefront.render_devices`` giving ``dev`` four times): its bytes
    equal the single frame's.  Then ``paths``, (label, scene, reps, meshes),
    each frame of ``parallel.mesh.render_frame`` over each (n_px, n_prim)
    against the single frame of the scene (bytes that differ, worst color
    difference), held to the oracle at the pixels of the scene's last
    oracle check, with each shard's walk, its walks and their counters
    beside the single frame's, the kernel launches, and the host and
    device frame times beside the single frame's (a mesh on one card only
    adds work: no gain is claimed).
    Fills ``launches`` with each path's kernel launches."""
    from ntracer_tpu_torch.engine import wavefront as wf
    from ntracer_tpu_torch.parallel import mesh as pmesh
    dev = torch.device(dev)
    one = torch.device(dev.type, 0) if dev.type == "cuda" else dev
    four = [one] * 4
    devices = wf.render_devices

    def render(sc, buf_):
        t1 = time.perf_counter()
        if not renderer.render(buf_, fmt, sc):
            raise SystemExit("render was aborted")
        return 1000 * (time.perf_counter() - t1)

    single_buf = bytearray(fmt.pitch * fmt.height)
    single_ms = [render(flagship, single_buf) for _ in range(reps + 1)][1:]
    single_dev = time_cuda(lambda: wf.dispatch_packed(flagship, fmt, dev),
                           reps)
    wf.render_devices = lambda device: four
    try:
        buf = bytearray(fmt.pitch * fmt.height)
        render(flagship, buf)
        reset_launches()
        render(flagship, buf)
        got = read_launches()
        slabs = wf.dispatch_packed(flagship, fmt, dev)
        px_ms = [render(flagship, buf) for _ in range(reps)]
        px_dev = time_cuda(lambda: wf.dispatch_packed(flagship, fmt, dev),
                           reps)
    finally:
        wf.render_devices = devices
    launches["px 4x1 flagship"] = got
    differ = int((np.frombuffer(bytes(buf), np.uint8)
                  != np.frombuffer(bytes(single_buf), np.uint8)).sum())
    print(f"   px 4x1 flagship through BlockingRenderer: {len(slabs)} slabs "
          f"from pixels {[s_ for s_, _t, _r in slabs]}, launches "
          f"{json.dumps({k: v for k, v in got.items() if v})}; {differ} "
          f"bytes differ from the single frame; host frame median "
          f"{np.median(px_ms):.3f} ms (single {np.median(single_ms):.3f}), "
          f"device frame {px_dev:.4f} ms (single {single_dev:.4f}) "
          f"[{name_limit}]")
    if differ or len(slabs) != 4 or got["nearest_hit"] != 4:
        raise SystemExit("the px 4x1 frame is not the single frame's, or "
                         "did not take one walk a shard")
    colors = pmesh.render_frame(flagship, fmt, pmesh.make_mesh(4, 1, four))
    oracle_recheck(flagship, colors)
    flagship._torch_mesh_cache = None

    for label, sc, reps_, meshes in paths:
        single = wf.frame_colors(sc, W, H, dev)
        s_host = []
        for _ in range(reps_):
            t1 = time.perf_counter()
            wf.frame_colors(sc, W, H, dev)
            s_host.append(1000 * (time.perf_counter() - t1))
        s_dev = time_cuda(lambda: wf._frame(sc, W, H, None, dev), reps_)
        # the counters of the frame in render_frame's own ray order (rows
        # of pixels, not 32x16 tiles) on one device: what the shards'
        # counters add up against
        _c, s_walks = shard_walks(lambda: pmesh.render_frame(
            sc, fmt, pmesh.make_mesh(1, 1, [one])))
        print(f"   {label}: a 1x1 mesh's walks {json.dumps(s_walks)}")
        for n_px, n_prim in meshes:
            name = f"{label} {n_px}x{n_prim}"
            mesh = pmesh.make_mesh(n_px, n_prim, [one] * (n_px * n_prim))
            t1 = time.perf_counter()
            rows, _cfg = pmesh._mesh_arrays(sc, mesh)
            build_s = time.perf_counter() - t1
            shards = rows[0].get("shards", [rows[0]])
            for j, shard in enumerate(shards):
                print(f"   {name}: shard {j} of {len(shards)} takes the "
                      f"{shard_kind(shard)}")
            reset_launches()
            colors, walks = shard_walks(
                lambda: pmesh.render_frame(sc, fmt, mesh))
            launches[name] = read_launches()
            host = []
            for _ in range(reps_):
                t1 = time.perf_counter()
                pmesh.render_frame(sc, fmt, mesh)
                host.append(1000 * (time.perf_counter() - t1))
            xs, ys = wf._strip_coords(W, 0, H)
            fn, rows = pmesh.get_sharded_renderer(sc, mesh, W * H)
            dev_ms = time_cuda(lambda: fn(rows, sc, W, H, xs, ys), reps_)
            differ, codes = byte_diffs(colors, single, fmt)
            worst = float(np.abs(colors - single).max())
            print(f"   {name}: layouts {build_s:.2f} s; walks by shard "
                  f"{json.dumps(walks)}; launches "
                  f"{json.dumps({k: v for k, v in launches[name].items() if v})}"
                  f"; {differ} bytes differ from the single frame (at most "
                  f"{codes} codes), worst color {worst:.3e}; host frame "
                  f"median {np.median(host):.3f} ms (single "
                  f"{np.median(s_host):.3f}), device frame {dev_ms:.4f} ms "
                  f"(single {s_dev:.4f}) [{name_limit}]")
            if n_prim > 1 and (len(walks) != n_prim or
                               any(c["trace"] < n_px for c in walks.values())):
                raise SystemExit(f"the {name} frame did not walk every "
                                 f"shard")
            if sum(launches[name].values()) < n_px * n_prim \
                    and not wf._scan(shards[0]):
                raise SystemExit(f"the {name} frame launched no kernel a "
                                 f"shard")
            if differ > W * H * 3 // 1000 or codes > 2:
                raise SystemExit(f"the {name} frame differs from the "
                                 f"single frame")
            oracle_recheck(sc, colors)
            sc._torch_mesh_cache = None


def glue_kernel(cases, dev, name_limit, reps=20):
    """The post-walk glue kernel (``wavefront.shade_pack``,
    csrc/shade_pack.cu) against its plain version (``_shade_pack_ref``,
    the chain it replaces) on the card (phase "glue kernel vs plain"), at
    each of ``cases`` ((label, scene, format), opaque unlit scenes): the
    packed streams equal byte for byte, the kernel's time (CUDA events,
    over ``reps`` launches) beside its bytes bound (``bytes_moved`` at
    ``PEAK_BYTES``: it reads a ray's walk key and direction and writes its
    pixel), the plain version's time.  Returns {label: case}."""
    from ntracer_tpu_torch.engine import packing
    from ntracer_tpu_torch.engine import shade_pack as sp
    from ntracer_tpu_torch.engine import wavefront as wf
    out = {}
    for label, sc, fmt in cases:
        key = packing.format_key(fmt)
        w, h = fmt.width, fmt.height
        cfg, arrs, _flat = wf.get_device_scene(sc, dev)
        if not wf._glue_fused(arrs, cfg, key):
            raise SystemExit(f"the glue kernel does not take {label}")
        fov, cam_o, cam_t = wf._camera(sc, w, h, dev)
        dyn = wf._scene_dyn(sc, dev)
        groups = wf._frame_groups(-(-(w * h) // wf.TILE))
        pctx = wf.primary_ctx(arrs, cfg, cam_o)
        xs, ys, unswz = wf._frame_coords(groups, w, dev)
        oT, dT = wf.make_rays(cam_o, cam_t, *fov, xs, ys)
        R = dT.shape[1]
        skip = torch.full((R,), -1, dtype=torch.int32, device=dev)
        walk = wf._walk(arrs, cfg, oT, dT, skip, True, None, pctx, 0, None)

        def kernel():
            return wf.shade_pack(arrs, cfg, dyn, cam_o, dT, walk, key,
                                 groups, w, unswz)

        def plain():
            return wf._shade_pack_ref(arrs, cfg, dyn, cam_o, dT, walk, key,
                                      unswz)

        got, want = kernel(), plain()
        diff = int((got != want).sum())
        hits = int(((walk["kid"] if "kid" in walk else walk["slot"])
                    >= 0).sum())
        bytes_ = sp.bytes_moved(cfg.d, R, key[1])
        bound_ms = 1000 * bytes_ / PEAK_BYTES
        ms = time_cuda(kernel, reps)
        plain_ms = time_cuda(plain, max(3, reps // 5))
        out[label] = {"d": cfg.d, "rays": R, "hits": hits, "bpp": key[1],
                      "err": diff, "ms": round(ms, 4),
                      "plain_ms": round(plain_ms, 4),
                      "bound_ms": round(bound_ms, 4), "bound_by": "bytes",
                      "share": round(100 * bound_ms / ms, 1)}
        print(f"   {label}: {json.dumps(out[label])} [{name_limit}]")
        if diff:
            raise SystemExit(f"the glue kernel's stream differs from its "
                             f"plain version's on {label} ({diff} words)")
    return out


def counters(paths, small, dev, name_limit):
    """``frame_stats`` of each of ``paths`` ((label, scene)) on the card
    (phase "counters"), and the card's counts of the small scene ``small``
    equal to the CPU's: its frame of 32x32 pixels with the frame's TILE
    lowered to 1,024 rays, so that the CPU's twins take seconds."""
    from ntracer_tpu_torch.engine import wavefront as wf
    out = {}
    for label, sc in paths:
        t1 = time.perf_counter()
        out[label] = wf.frame_stats(sc, W, H, dev)
        print(f"   {label}: {json.dumps(out[label])} "
              f"({1000 * (time.perf_counter() - t1):.1f} ms)")
    tile = wf.TILE
    wf.TILE = 1024
    try:
        card_ = wf.frame_stats(small, 32, 32, dev)
        host = wf.frame_stats(small, 32, 32, "cpu")
    finally:
        wf.TILE = tile
    print(f"   small lit glass scene, 32x32 (1,024 rays): card "
          f"{json.dumps(card_)}, CPU {json.dumps(host)}")
    if card_ != host or not card_.get("occl_chunks_visited"):
        raise SystemExit("the card's counters differ from the CPU's")
    return out


_ORACLE_SCENE = None


def _oracle_pixel(xy):
    return _ORACLE_SCENE._pixel_color(*xy)


def oracle_colors(scene, pixels):
    """The scalar oracle's colors at ``pixels``, from ``ORACLE_WORKERS``
    forked processes (the oracle is plain Python and NumPy: the workers
    never touch the card).  The pool is closed before this returns."""
    global _ORACLE_SCENE
    _ORACLE_SCENE = scene
    ctx = multiprocessing.get_context("fork")
    try:
        with ctx.Pool(ORACLE_WORKERS) as pool:
            return pool.map(_oracle_pixel, pixels, chunksize=1)
    finally:
        _ORACLE_SCENE = None


# (pixels, the oracle's colors there, tolerance) of each scene's last
# oracle_check, by the scene's id: a later frame of the same view is held to
# them without asking the oracle again (oracle_recheck)
ORACLE_REFS = {}


def oracle_check(scene, colors, pixels, tol=ORACLE_TOL):
    """Hold ``colors`` (H, W, 3) against the scalar oracle at ``pixels``."""
    scene._set_view_size(W, H)
    refs = oracle_colors(scene, pixels)
    ORACLE_REFS[id(scene)] = (pixels, refs, tol)
    hold_to_oracle(colors, pixels, refs, tol)


def oracle_recheck(scene, colors):
    """Hold ``colors`` of ``scene``'s view to the oracle's colors at the
    pixels of its last ``oracle_check``."""
    hold_to_oracle(colors, *ORACLE_REFS[id(scene)])


def hold_to_oracle(colors, pixels, refs, tol):
    if colors.shape != (H, W, 3) or not np.isfinite(colors).all():
        raise SystemExit(f"bad frame colors: shape {colors.shape}")
    over = []
    worst = 0.0
    for (x, y), ref in zip(pixels, refs):
        diff = float(np.abs(ref - colors[y, x]).max())
        worst = max(worst, diff)
        if diff > tol:
            over.append((x, y, diff))
            print(f"   pixel ({x}, {y}): port {colors[y, x]}, oracle {ref}, "
                  f"diff {diff}")
    print(f"   {len(pixels)} pixels, worst diff {worst}, "
          f"{len(over)} beyond {tol}")
    if len(over) > ORACLE_MAX_OVER:
        raise SystemExit("the frame disagrees with the oracle")


RESIDENT = ("nearest_hit", "occluded", "nearest_hit_transparent",
            "occluded_transparent")
STREAMING = tuple(name + "_hbm" for name in RESIDENT)
# kernels 2.9 and 2.10: grid_kernels.nearest_hit and .occluded (d > 8)
GRID = ("grid_nearest_hit", "grid_occluded")
WALKS = RESIDENT + STREAMING + GRID


def walk_wrappers():
    """Every kernel's wrapper by its name in the ``kernels`` line."""
    from ntracer_tpu_torch.engine import grid_kernels as gk
    from ntracer_tpu_torch.engine import resident_kernels as rk
    from ntracer_tpu_torch.engine import wavefront as wf
    fns = {name: getattr(rk, name) for name in RESIDENT + STREAMING}
    fns.update(grid_nearest_hit=gk.nearest_hit, grid_occluded=gk.occluded,
               shade_pack=wf.shade_pack)
    return fns


def reset_launches():
    for fn in walk_wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in walk_wrappers().items()}


def live_launches(entry, run):
    """Run ``run()`` and count the launches of the occlusion walk's C entry
    ``entry`` (``resident_kernels._occlusion_kernel`` records them): (live,
    dead), a launch live when a block of it visited a chunk (its visits per
    block have an entry > 0)."""
    from ntracer_tpu_torch.engine import resident_kernels as rk
    launch = rk._occlusion_kernel
    visits = []

    def recording(name, w, dev, then=None):
        err, out = launch(name, w, dev, then)
        if name == entry:
            visits.append(out[-1])
        return err, out

    rk._occlusion_kernel = recording
    try:
        run()
    finally:
        rk._occlusion_kernel = launch
    live = sum(int(bool((v > 0).any())) for v in visits)
    return live, len(visits) - live


def bit_diffs(a, b):
    """How many float32 entries differ in their bits."""
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def pick_pixels(rng, quotas, masks, exclude=None):
    """Seeded (x, y) pixels: ``quotas`` maps a mask's name (or None for any
    pixel) to how many to draw from it; pixels of ``exclude`` are never
    drawn.  ``masks`` are (H, W) bool arrays, as ``frame_colors`` gives
    them."""
    free = np.ones((H, W), bool) if exclude is None else ~exclude
    pixels = []
    for name, n in quotas.items():
        pool = np.nonzero((free if name is None else masks[name] & free)
                          .reshape(-1))[0]
        if len(pool) == 0:
            raise SystemExit(f"no pixel of the frame is {name}")
        pixels += [divmod(int(p), W)[::-1]
                   for p in rng.choice(pool, size=n, replace=len(pool) < n)]
    return pixels


def count_in(pixels, mask):
    return sum(bool(mask[y, x]) for x, y in pixels)


def main():
    t0 = phase("device")
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    name_limit = card()
    kind = torch.cuda.get_device_name(0)
    print(name_limit)
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): {kind}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    done(t0)

    sys.path.insert(0, REPO)
    import ntracer_tpu_torch as nt_torch
    from ntracer_tpu_torch import NTracer, Material, ImageFormat, Channel
    from ntracer_tpu_torch import kdnodes, kdtree
    from ntracer_tpu_torch.engine import _build
    from ntracer_tpu_torch.engine import grid_kernels as gk
    from ntracer_tpu_torch.engine import resident_kernels as rk
    from ntracer_tpu_torch.engine import wavefront as wf

    t0 = phase("build")
    lib_path = _build.build()
    _build.load()
    print(f"   {os.path.relpath(lib_path, REPO)}")
    with open(os.path.join(_build.BUILD_DIR, "nvcc.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("   " + line.strip())
    div_ops, div_body = div_sass_ops(
        _build.BUILD_DIR, _build.find_nvcc(),
        [a for a in _build.NVCC_FLAGS if a not in ("-Xptxas", "-v")])
    print(f"   div.rn.f32 executes {div_ops} instructions on its fast path "
          f"(walk_bound counts DIV_OPS = {DIV_OPS}): {'; '.join(div_body)}")
    done(t0)

    t0 = phase("scene")
    nt = NTracer(4)
    cam_distance = -4.0
    opaque = Material((1, 0.5, 0.5))
    scene, camera, n_simplices = cell120_scene(nt, opaque, cam_distance,
                                               lit=False)
    cfg, arrs, _flat = wf.get_device_scene(scene, dev)
    print(f"   flagship: {n_simplices} simplices, pool "
          f"{tuple(arrs['res_gt'].shape)}, d={cfg.d}")
    # the flagship's geometry under two lights, and with every other
    # simplex of glass (tests/test_pallas.py's mix)
    lit120, lit120_camera, _n = cell120_scene(nt, opaque, cam_distance,
                                              lit=True)
    solid, glass_m = Material((0.3, 0.8, 0.5)), \
        Material((1, 0.7, 0.7), opacity=0.4)

    def alternate(i):
        return glass_m if i % 2 else solid

    glass, glass_camera, _n = cell120_scene(nt, alternate, cam_distance,
                                            lit=True)
    gcfg, garrs, _flat = wf.get_device_scene(glass, dev)
    K = gcfg.max_transparent_hits
    print(f"   glass 120-cell: pool {tuple(garrs['res_gt'].shape)}, "
          f"{int((garrs['res_opa'][:, 0] < 1).sum())} glass slots, K={K}, "
          f"{gcfg.n_point_lights} point and {gcfg.n_global_lights} global "
          f"light, shadows {gcfg.shadows}")
    # the scenes the oracle is asked about are built unbatched: its
    # transparent hits then mean what the engine's do
    with unbatched(kdtree):
        glass_u, _cam, _n = cell120_scene(nt, alternate, cam_distance,
                                          lit=True)
        d3 = mesh_d3_scene(NTracer(3), Material((0.7, 0.8, 1.0),
                                                opacity=0.45), 500)
    shadows_d3 = mesh_d3_scene(NTracer(3), Material((0.9, 0.6, 0.3)), 700)
    dcfg, darrs, _flat = wf.get_device_scene(d3, dev)
    print(f"   transparent d=3: 500 glass triangles, pool "
          f"{tuple(darrs['res_gt'].shape)}")
    nt6 = NTracer(6)
    lit, lit_camera = lit_scene(nt6, Material)
    lit_distance = -8.0
    lcfg, larrs, _flat = wf.get_device_scene(lit, dev)
    print(f"   lit: 900 simplices, pool {tuple(larrs['res_gt'].shape)}, "
          f"d={lcfg.d}, {lcfg.n_point_lights} point and "
          f"{lcfg.n_global_lights} global lights, shadows {lcfg.shadows}")
    done(t0)

    # the mesh: an OBJ file through the port's loader, a pool over the line
    t0 = phase("mesh scenes")
    from ntracer_tpu_torch.wavefront_obj import load_obj
    nt3 = NTracer(3)
    tris = sphere_mesh(MESH_TRIS)
    with tempfile.TemporaryDirectory() as tmp:
        obj_path = os.path.join(tmp, "sphere.obj")
        t1 = time.perf_counter()
        write_obj(tris, obj_path)
        obj_mb = os.path.getsize(obj_path) / 2 ** 20
        t2 = time.perf_counter()
        mesh_protos = load_obj(obj_path, nt3)
        t3 = time.perf_counter()
    if not np.array_equal(mesh_protos._src_arrays["pts"], tris):
        raise SystemExit("load_obj did not read back the mesh")
    mesh, mesh_camera = mesh_scene(nt3, mesh_protos)
    t4 = time.perf_counter()
    mcfg, marrs, _flat = wf.get_device_scene(mesh, dev)
    t5 = time.perf_counter()
    n_chunks = marrs["res_gt"].shape[0]
    print(f"   mesh: {len(tris)} triangles, OBJ {obj_mb:.1f} MiB written in "
          f"{t2 - t1:.2f} s, load_obj {t3 - t2:.2f} s, scene build "
          f"{t4 - t3:.2f} s, device scene {t5 - t4:.2f} s; pool "
          f"{tuple(marrs['res_gt'].shape)}, "
          f"{rk.pool_bytes(n_chunks * rk.CK, 3) / 2 ** 20:.1f} MiB against "
          f"the line's {rk.STREAM_POOL_BYTES / 2 ** 20:.0f} MiB, streams "
          f"{'res_is_hbm' in marrs}")
    if "res_is_hbm" not in marrs:
        raise SystemExit("the mesh's pool is not over the line")
    # the same triangles, opaque and glass by turns (the glass 120-cell's
    # mix).  The oracle is asked about this scene as it is, batched: a ray
    # crosses the sphere's surface at two far apart points, so no triangle
    # batch holds two of its glass hits (but at a shared edge), and the
    # oracle's one transparent hit per batch per leaf is every hit.  (An
    # unbatched copy builds in 11-13 s, but its oracle takes 72-86 s a
    # pixel on the CPU against 1.2-4.1 s batched.)
    solid3, glass3 = Material((0.3, 0.8, 0.5)), \
        Material((1, 0.7, 0.7), opacity=0.4)
    mix = [glass3 if i % 2 else solid3 for i in range(len(tris))]
    t1 = time.perf_counter()
    gmesh, gmesh_camera = mesh_scene(
        nt3, nt3.TrianglePrototype.batch_from_points(tris, mix))
    t2 = time.perf_counter()
    gmcfg, gmarrs, _flat = wf.get_device_scene(gmesh, dev)
    t3 = time.perf_counter()
    print(f"   glass mesh: {int((gmarrs['res_opa'][:, 0] < 1).sum())} glass "
          f"slots, K={gmcfg.max_transparent_hits}, scene build {t2 - t1:.2f} "
          f"s, device scene {t3 - t2:.2f} s; streams "
          f"{'res_is_hbm' in gmarrs}")
    if "res_is_hbm" not in gmarrs:
        raise SystemExit("the glass mesh's pool is not over the line")
    done(t0)

    # scenes of more than 8 dimensions: the grid walks (kernels 2.9, 2.10)
    t0 = phase("d > 8 scenes")
    nt10 = NTracer(10)
    t1 = time.perf_counter()
    orth, orth_camera, n_orth = orthoplex_scene(nt10, opaque)
    ocfg, oarrs, _flat = wf.get_device_scene(orth, dev)
    n_tiles = oarrs["kern_gt"].shape[1] // 512
    print(f"   orthoplex d=10: {n_orth} simplices, pool "
          f"{tuple(oarrs['kern_gt'].shape)} ({n_tiles} tiles), "
          f"{ocfg.n_point_lights} point and {ocfg.n_global_lights} "
          f"global light, shadows {ocfg.shadows}; built in "
          f"{time.perf_counter() - t1:.2f} s")
    ntg = NTracer(10, force_generic=True)
    generic = generic_scene(ntg, Material((0.8, 0.5, 0.9)))
    orth9, _cam, n_orth9 = orthoplex_scene(NTracer(9), opaque)
    o9cfg, o9arrs, _flat = wf.get_device_scene(orth9, dev)
    t1 = time.perf_counter()
    pool16, simplices16 = random_pool(NTracer(16), Material((0.8, 0.5, 0.9)),
                                      200)
    p16cfg, p16arrs, _flat = wf.get_device_scene(pool16, dev)
    print(f"   orthoplex d=9: {n_orth9} simplices, pool "
          f"{tuple(o9arrs['kern_gt'].shape)}; random d=16: 200 simplices, "
          f"pool {tuple(p16arrs['kern_gt'].shape)}, built in "
          f"{time.perf_counter() - t1:.2f} s")
    # past d = 16 (the wide bodies): the wide d=20 path's scene, and pools
    # of 200 random simplices at d = 17, 24 and 32 straight from their rows
    # (the k-d build of such scenes takes minutes), in the camera's view
    # from -8 on axis 2
    t1 = time.perf_counter()
    nt20 = NTracer(20)
    wide, wide_camera, n_wide = wide_scene(nt20, opaque)
    wcfg, warrs, _flat = wf.get_device_scene(wide, dev)
    t2 = time.perf_counter()
    wide_pools = {}
    for d_ in WIDE_POOL_DS:
        pts_ = random_simplices(200, d_)
        wide_pools[d_] = (pts_, simplex_pool(pts_, dev))
    print(f"   wide d=20: {n_wide} simplices (the 20-simplex's 21 facets and "
          f"200 random), pool {tuple(warrs['kern_gt'].shape)}, "
          f"{wcfg.n_point_lights} point and {wcfg.n_global_lights} global "
          f"light, shadows {wcfg.shadows}, built in {t2 - t1:.2f} s; random "
          f"pools at d = {', '.join(map(str, WIDE_POOL_DS))}: 200 simplices, "
          f"pools {[tuple(p['kern_gt'].shape) for _s, p in wide_pools.values()]}"
          f", {time.perf_counter() - t2:.2f} s")
    if not all("kern_gt" in a and not any(k.startswith("res_") for k in a)
               for a in (oarrs, o9arrs, p16arrs, warrs)):
        raise SystemExit("a d > 8 scene has no grid layout")
    done(t0)

    # solids among the triangles of each kind of pool, each scene in one
    # k-d leaf (the oracle's build misplaces solids), and a transparent
    # pool of d > 8 (the chunk scan)
    t0 = phase("solid scenes")
    t1 = time.perf_counter()
    nt4 = NTracer(4)
    sol4, sol4_camera = solids_d4_scene(nt4, Material)
    s4cfg, s4arrs, _flat = wf.get_device_scene(sol4, dev)
    gsol3, gsol3_camera = glass_solids_d3_scene(nt3, Material)
    gs3cfg, gs3arrs, _flat = wf.get_device_scene(gsol3, dev)
    sorth, sorth_camera, _n = solid_orthoplex_scene(
        nt10, opaque, Material((0.4, 0.9, 0.6)))
    socfg, soarrs, _flat = wf.get_device_scene(sorth, dev)
    gorth, gorth_camera, _n = solid_orthoplex_scene(
        nt10, solid, Material((0.5, 0.9, 0.9), opacity=0.4), glass=glass_m)
    gocfg, goarrs, _flat = wf.get_device_scene(gorth, dev)
    for label, cfg_, arrs_ in (("solids d=4", s4cfg, s4arrs),
                               ("glass solids d=3", gs3cfg, gs3arrs),
                               ("solid orthoplex d=10", socfg, soarrs),
                               ("glass orthoplex d=10", gocfg, goarrs)):
        pool = "grid" if wf._grid(arrs_) else "scan" if wf._scan(arrs_) \
            else "chunk walk"
        kinds = ["cube" if int(t_) == CUBE else "sphere"
                 for t_ in arrs_["sol_type"][:cfg_.n_solids].tolist()]
        opacity = [float(arrs_["mat_pack"][int(m_), 6])
                   for m_ in arrs_["sol_mat"].tolist()]
        print(f"   {label}: {cfg_.n_tris} pool slots ({pool}), solids "
              f"{kinds}, opacity {opacity}, transparency "
              f"{cfg_.has_transparency}, "
              f"{cfg_.n_point_lights} point and {cfg_.n_global_lights} "
              f"global light")
    if not ("res_gt" in s4arrs and "res_opa" in gs3arrs and
            wf._grid(soarrs) and wf._scan(goarrs)):
        raise SystemExit("a solid scene took another pool layout")
    print(f"   built in {time.perf_counter() - t1:.2f} s")
    done(t0)

    fmt = ImageFormat(W, H, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])
    buf = bytearray(fmt.pitch * fmt.height)
    fmt_key = wf.packing.format_key(fmt)
    groups = wf._frame_groups(-(-(W * H) // wf.TILE))
    xs, ys, _unswz = wf._frame_coords(groups, W, dev)

    def primary(sc, cfg_, arrs_):
        """The frame's primary wavefront (1,048,576 rays, in the frame's
        block order) and its hits."""
        fov_ = wf._fov_params(W, H, sc.fov)
        cam_o_ = torch.as_tensor(sc._cam._origin, device=dev)
        cam_t_ = torch.as_tensor(sc._cam._t, device=dev)
        oT_, dT_ = wf.make_rays(cam_o_, cam_t_, *fov_, xs, ys)
        pctx_ = wf.primary_ctx(arrs_, cfg_, cam_o_)
        skip_ = torch.full((dT_.shape[1],), -1, dtype=torch.int32,
                           device=dev)
        hit_ = wf.trace_pool(arrs_, cfg_, oT_, dT_, skip_,
                             shared_origin=cam_o_, pctx=pctx_)
        return fov_, cam_o_, cam_t_, oT_, dT_, pctx_, skip_, hit_

    # kernel 2.1 in both walk modes at the flagship's full primary
    # wavefront: primary rays with the shared-origin rows and the
    # front-to-back order, and a bounce wavefront (reflections off the
    # primary hits, every other block inactive, each ray skipping the
    # surface it leaves) in pool order; then the lit frame's primary
    # wavefront (d = 6)
    t0 = phase("nearest_hit kernel vs twin")
    fov, cam_o, cam_t, oT, dT, pctx, skip, hit = primary(scene, cfg, arrs)
    lfov, lcam_o, lcam_t, loT, ldT, lpctx, lskip, lhit = primary(
        lit, lcfg, larrs)
    res = wf._res_dict(arrs)
    lres = wf._res_dict(larrs)
    R = dT.shape[1]
    nrm = hit["normalT"]
    sine = -wf._dotT(dT, nrm)
    blk = torch.arange(R, device=dev) // rk.RAY_BLOCK
    modes = {
        "primary": (cfg, arrs, res, oT, dT, skip,
                    dict(order=pctx["order"], sh=pctx["sh_res"])),
        "bounce": (cfg, arrs, res, hit["pointT"],
                   wf._unitT(dT - nrm * (-2 * sine)[None, :]), hit["pid"],
                   dict(active=hit["hit"] & (blk % 2 == 0))),
        "lit primary": (lcfg, larrs, lres, loT, ldT, lskip,
                        dict(order=lpctx["order"], sh=lpctx["sh_res"])),
    }
    near = {}
    for label, (cfg_, arrs_, res_, o_, d_, s_, kw) in modes.items():
        args = (res_, o_, d_, s_, cfg_.d)
        kt, ks, kv = rk.nearest_hit(*args, **kw)
        pt, ps, pv = rk.nearest_hit_ref(*args, **kw)
        torch.cuda.synchronize()
        slot_diff = int((ks != ps).sum())
        t_diff = int((kt.view(torch.int32) != pt.view(torch.int32)).sum())
        vis_diff = int((kv != pv).sum())
        # 2.1 launches 2.5's body: the streaming entry on the same inputs
        ht, hs, hv = rk.nearest_hit_hbm(*args, **kw)
        vs_2_5 = dict(slot=int((ks != hs).sum()), t_bits=bit_diffs(kt, ht),
                      visits=int((kv != hv).sum()))
        err = float(torch.nan_to_num(torch.abs(kt - pt), nan=float("inf"))
                    .max())
        ms = time_cuda(lambda: rk.nearest_hit(*args, **kw), 20)
        twin_ms = time_cuda(lambda: rk.nearest_hit_ref(*args, **kw), 2)
        read = kw.get("active", torch.ones_like(ks, dtype=torch.bool))
        need = read & (rk._scene_exit_T(o_, d_, res_["b_lo"],
                                        res_["b_hi"]) > 0)
        bound_ms, bound_by = walk_bound(
            cfg_.d, "sh" in kw, need, read,
            nearest_stages(*args, kw, kt, kv), arrs_["res_neff"],
            pool_bytes(arrs_), int("active" in kw), R * 8 + kv.numel() * 4)
        near[label] = dict(ms=ms, plain_ms=twin_ms, bound_ms=bound_ms,
                           bound_by=bound_by, err=err)
        print(f"   {label}: {R} rays, {int(need.sum())} to test, "
              f"{int((ks >= 0).sum())} hits, "
              f"slot diffs {slot_diff}, t bit diffs {t_diff}, visit diffs "
              f"{vis_diff}, diffs against 2.5 {json.dumps(vs_2_5)}, max |dt| "
              f"{err}, visits/block "
              f"{float(kv.float().mean()):.4f}; kernel {ms:.4f} ms, twin "
              f"{twin_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of the bound reached "
              f"[{name_limit}]")
        if slot_diff or t_diff or vis_diff or any(vs_2_5.values()):
            raise SystemExit(f"nearest_hit kernel != twin or 2.5 in {label} "
                             f"mode")
    # kernel 2.1 launches 2.5's body (stream_walk.cuh): as it launches at
    # the flagship's d and the lit configuration's
    near_info = {}
    for d_ in (cfg.d, lcfg.d):
        for shared in (True, False):
            near_info[d_, shared] = rk.stream_info("nearest_hit", d_, shared)
            print(f"   nearest_hit at d = {d_}"
                  f"{' (shared rows)' if shared else ''}: "
                  f"{near_info[d_, shared]}")
    # the entry pass alone on the flagship pool: every block live, every
    # origin far outside the pool's box, pointing away, and a start
    # distance no chunk is within, so no block visits a chunk
    far = torch.full((cfg.d, R), 10.0, device=dev)
    away = torch.full((cfg.d, R), cfg.d ** -0.5, device=dev)
    none = torch.full((R,), -1, dtype=torch.int32, device=dev)
    pw = rk._walk_inputs(res, far, away, none, cfg.d, None, None, None)
    pw["init_t"] = torch.full((R,), 1e-30, device=dev)
    pw["blive"] = torch.ones_like(pw["blive"])

    def flagship_entry_probe():
        err, got = rk._nearest_kernel("ntr_nearest_hit", pw, far.device)
        if err:
            raise SystemExit(f"the 2.1 entry-pass probe failed: {err}")
        return got

    kt, ks, kv = flagship_entry_probe()
    if bool(kv.any()) or bool((ks >= 0).any()):
        raise SystemExit("the 2.1 entry-pass probe visited a chunk")
    entry_1_ms = time_cuda(flagship_entry_probe, 5)
    print(f"   2.1 (2.5's body) entry pass alone ({R // 512} live blocks x "
          f"{int(arrs['res_neff'])} chunks): {entry_1_ms:.4f} ms, "
          f"{100 * entry_1_ms / near['primary']['ms']:.1f}% of the primary "
          f"walk [{name_limit}]")
    done(t0)

    # kernel 2.2 at the lit frame's full wavefront: 1,048,576 shadow rays
    # leaving the primary hit points (misses inactive, each ray skipping the
    # surface it lies on) towards the first point light (finite distances)
    # and along the global light (REAL_MAX cut to the pool's box); then the
    # same towards a point light from the flagship's hit points, where most
    # blocks are live; then a wavefront without any active ray
    t0 = phase("occluded kernel vs twin")
    # kernel 2.2 launches 2.6's body (stream_walk.cuh) on any pool: as it
    # launches at the lit configuration's d and the flagship's
    occ_info = {d_: rk.stream_info("occluded", d_) for d_ in (lcfg.d, cfg.d)}
    for d_, info in occ_info.items():
        print(f"   occluded at d = {d_}: {info}")

    def shadow_rays(arrs_, hit_, light_pos=None, light_dir=None):
        point = torch.where(hit_["hit"][None, :], hit_["pointT"], 0.0)
        if light_pos is not None:
            lv = point - light_pos[:, None]
            dist = rk._sqrt(wf._dotT(lv, lv))
            return point, (lv / dist[None, :]).contiguous(), \
                torch.where(hit_["hit"], dist, 0.0)
        ld = (-light_dir)[:, None].expand_as(point).contiguous()
        exit_t = rk._scene_exit_T(point, ld, arrs_["res_blo"],
                                  arrs_["res_bhi"])
        return point, ld, torch.where(hit_["hit"], exit_t, 0.0)

    flagship_light = torch.tensor([0.0, 3.0, -3.0, 1.0], device=dev)
    cases = {
        "lit point light": (lcfg, larrs, lres, lhit, shadow_rays(
            larrs, lhit, light_pos=larrs["pl_pos"][0])),
        "lit global light": (lcfg, larrs, lres, lhit, shadow_rays(
            larrs, lhit, light_dir=larrs["gl_dir"][0])),
        "flagship point light": (cfg, arrs, res, hit, shadow_rays(
            arrs, hit, light_pos=flagship_light)),
    }
    occ = {}
    for label, (cfg_, arrs_, res_, hit_, (point, dirs, ldist)) in \
            cases.items():
        args = (res_, point, dirs, ldist, hit_["pid"], cfg_.d)
        kb, kv = rk.occluded(*args)
        pb, pv = rk.occluded_ref(*args)
        torch.cuda.synchronize()
        ray_diff = int((kb != pb).sum())
        vis_diff = int((kv != pv).sum())
        ms = time_cuda(lambda: rk.occluded(*args), 20)
        twin_ms = time_cuda(lambda: rk.occluded_ref(*args), 2)
        bound_ms, bound_by = walk_bound(
            cfg_.d, False, ldist > 0, ldist > 0,
            occlusion_stages(*args, kb, kv)[0], arrs_["res_neff"],
            pool_bytes(arrs_), 4, R + kv.numel() * 4, early=kb)
        occ[label] = dict(ms=ms, plain_ms=twin_ms, bound_ms=bound_ms,
                          bound_by=bound_by, err=float(ray_diff))
        print(f"   {label}: {R} rays, {int((ldist > 0).sum())} active, "
              f"{int(kb.sum())} blocked, blocked diffs {ray_diff}, visit "
              f"diffs {vis_diff}, live blocks {int((kv > 0).sum())}, "
              f"visits/block {float(kv.float().mean()):.4f}; kernel "
              f"{ms:.4f} ms, twin {twin_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), {100 * bound_ms / ms:.1f}% of the bound "
              f"reached [{name_limit}]")
        if ray_diff or vis_diff:
            raise SystemExit(f"occluded kernel != twin: {label}")
        if label.startswith("flagship") and not 0 < int(kb.sum()) < \
                int((ldist > 0).sum()):
            raise SystemExit("the dense occlusion case decides nothing")
    point, dirs, ldist = cases["lit global light"][4]
    dead = torch.zeros_like(ldist)
    kb, kv = rk.occluded(lres, point, dirs, dead, lhit["pid"], lcfg.d)
    if bool(kb.any()) or bool(kv.any()):
        raise SystemExit("a dead wavefront was walked")
    dead_ms = time_cuda(lambda: rk.occluded(lres, point, dirs, dead,
                                            lhit["pid"], lcfg.d), 20)
    dead_bound, _by = walk_bound(lcfg.d, False, dead > 0, dead > 0,
                                 [0] * (lcfg.d + 1), larrs["res_neff"], 0, 4,
                                 R + kv.numel() * 4)
    print(f"   dead wavefront: {R} inactive rays, kernel {dead_ms:.4f} ms "
          f"(wrapper included), bound {dead_bound:.4f} ms (bytes) "
          f"[{name_limit}]")
    done(t0)

    # kernel 2.3 at full primary wavefronts: the glass 120-cell's primary
    # rays (shared-origin rows, front-to-back order), a bounce wavefront off
    # its opaque hits (pool order, every other block inactive, each ray
    # skipping the surface it leaves), and the primary rays of the
    # "transparent d=3" scene, where rays cross more glass than K slots hold
    t0 = phase("nearest_hit_transparent kernel vs twin")
    _f, gcam_o, _t, goT, gdT, gpctx, gskip, ghit = primary(glass, gcfg, garrs)
    _f, _o, _t, doT, ddT, dpctx, dskip, dhit = primary(d3, dcfg, darrs)
    gres, dres = wf._res_dict(garrs), wf._res_dict(darrs)
    # kernel 2.3 launches 2.7's body in groups of one (stream_walk.cuh): as
    # it launches at the glass 120-cell's d and the d=3 scene's
    t3_info = {}
    for d_ in (gcfg.d, dcfg.d):
        for shared in (True, False):
            t3_info[d_, shared] = rk.stream_info("nearest_hit_transparent",
                                                 d_, shared)
            print(f"   nearest_hit_transparent at d = {d_}"
                  f"{' (shared rows)' if shared else ''}: "
                  f"{t3_info[d_, shared]}")
    gsine = -wf._dotT(gdT, ghit["normalT"])
    tmodes = {
        "glass primary": (gcfg, garrs, gres, goT, gdT, gskip,
                          dict(order=gpctx["order"], sh=gpctx["sh_res"])),
        "glass bounce": (gcfg, garrs, gres, ghit["pointT"], wf._unitT(
            gdT - ghit["normalT"] * (-2 * gsine)[None, :]), ghit["pid"],
            dict(active=ghit["hit"] & (blk % 2 == 0))),
        "d3 primary": (dcfg, darrs, dres, doT, ddT, dskip,
                       dict(order=dpctx["order"], sh=dpctx["sh_res"])),
    }
    near_t = {}
    for label, (cfg_, arrs_, res_, o_, d_, s_, kw) in tmodes.items():
        args = (res_, o_, d_, s_, cfg_.d, K)
        kt, ks, ktt, kts, kv = rk.nearest_hit_transparent(*args, **kw)
        pt, ps, ptt, pts, pv = rk.nearest_hit_transparent_ref(*args, **kw)
        replaced = rk.nearest_hit_transparent_ref.replaced
        torch.cuda.synchronize()
        diffs = dict(slot=int((ks != ps).sum()), t_bits=bit_diffs(kt, pt),
                     tslot=int((kts != pts).sum()),
                     tt_bits=bit_diffs(ktt, ptt), visits=int((kv != pv).sum()))
        err = max(float(torch.nan_to_num(
            torch.where(a.view(torch.int32) == b.view(torch.int32), 0.0,
                        torch.abs(a - b)), nan=float("inf")).max())
            for a, b in ((kt, pt), (ktt, ptt)))
        ms = time_cuda(lambda: rk.nearest_hit_transparent(*args, **kw), 20)
        twin_ms = time_cuda(
            lambda: rk.nearest_hit_transparent_ref(*args, **kw), 2)
        read = kw.get("active", torch.ones_like(ks, dtype=torch.bool))
        need = read & (rk._scene_exit_T(o_, d_, res_["b_lo"],
                                        res_["b_hi"]) > 0)
        bound_ms, bound_by = walk_bound(
            cfg_.d, "sh" in kw, need, read,
            nearest_stages(*args[:5], kw, kt, kv, K=K), arrs_["res_neff"],
            pool_bytes(arrs_, opacity=True), int("active" in kw),
            R * 8 + K * R * 8 + kv.numel() * 4)
        filled = kts >= 0
        near_t[label] = dict(ms=ms, plain_ms=twin_ms, bound_ms=bound_ms,
                             bound_by=bound_by, err=err, replaced=replaced)
        print(f"   {label}: {R} rays, {int(need.sum())} to test, "
              f"{int((ks >= 0).sum())} opaque hits, {int(filled.sum())} "
              f"slots filled, {int(filled.all(dim=0).sum())} rays filled all "
              f"{K}, {replaced} slots replaced; diffs {json.dumps(diffs)}, "
              f"max |dt| {err}, visits/block {float(kv.float().mean()):.4f};"
              f" kernel {ms:.4f} ms, twin {twin_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% "
              f"of the bound reached [{name_limit}]")
        if any(diffs.values()):
            raise SystemExit(f"nearest_hit_transparent kernel != twin: "
                             f"{label}")
        if not int(filled.sum()):
            raise SystemExit(f"no transparent slot was filled: {label}")
    if not near_t["d3 primary"]["replaced"]:
        raise SystemExit("the d=3 case never replaces a slot")
    done(t0)

    # kernel 2.4 at full wavefronts: shadow rays from the glass 120-cell's
    # opaque hit points and from the first glass surface of the d=3 scene's
    # rays, to the point light and along the global light; then a wavefront
    # without any active ray
    t0 = phase("occluded_transparent kernel vs twin")
    # kernel 2.4 launches 2.8's body (stream_walk.cuh) on any pool
    t_info = {d_: rk.stream_info("occluded_transparent", d_)
              for d_ in (gcfg.d, dcfg.d)}
    for d_, info in t_info.items():
        print(f"   occluded_transparent at d = {d_}: {info}")
    dfirst = dhit["tidT"][0] >= 0
    dsurf = dict(hit=dfirst, pid=torch.where(dfirst, dhit["tidT"][0], -1),
                 pointT=doT + dhit["ttT"][0][None, :] * ddT)
    tcases = {
        "glass point light": (gcfg, garrs, gres, ghit, shadow_rays(
            garrs, ghit, light_pos=garrs["pl_pos"][0])),
        "glass global light": (gcfg, garrs, gres, ghit, shadow_rays(
            garrs, ghit, light_dir=garrs["gl_dir"][0])),
        "d3 point light": (dcfg, darrs, dres, dsurf, shadow_rays(
            darrs, dsurf, light_pos=darrs["pl_pos"][0])),
        "d3 global light": (dcfg, darrs, dres, dsurf, shadow_rays(
            darrs, dsurf, light_dir=darrs["gl_dir"][0])),
    }
    occ_t = {}
    for label, (cfg_, arrs_, res_, hit_, (point, dirs, ldist)) in \
            tcases.items():
        args = (res_, point, dirs, ldist, hit_["pid"], cfg_.d)
        kb, kf, kv = rk.occluded_transparent(*args)
        pb, pf, pv = rk.occluded_transparent_ref(*args)
        torch.cuda.synchronize()
        diffs = dict(blocked=int((kb != pb).sum()), filt_bits=bit_diffs(kf, pf),
                     visits=int((kv != pv).sum()))
        ms = time_cuda(lambda: rk.occluded_transparent(*args), 20)
        twin_ms = time_cuda(lambda: rk.occluded_transparent_ref(*args), 2)
        bound_ms, bound_by = walk_bound(
            cfg_.d, False, ldist > 0, ldist > 0,
            occlusion_stages(*args, kb, kv, filtered=True)[0],
            arrs_["res_neff"], pool_bytes(arrs_, opacity=True), 4,
            R * 5 + kv.numel() * 4, early=kb)
        n_filtered = int(((kf < 1) & ~kb).sum())
        occ_t[label] = dict(ms=ms, plain_ms=twin_ms, bound_ms=bound_ms,
                            bound_by=bound_by,
                            err=float(torch.abs(kf - pf).max()))
        print(f"   {label}: {R} rays, {int((ldist > 0).sum())} active, "
              f"{int(kb.sum())} blocked, {n_filtered} unblocked behind "
              f"glass; diffs {json.dumps(diffs)}, live blocks "
              f"{int((kv > 0).sum())}, visits/block "
              f"{float(kv.float().mean()):.4f}; kernel {ms:.4f} ms, twin "
              f"{twin_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of the bound reached "
              f"[{name_limit}]")
        if any(diffs.values()):
            raise SystemExit(f"occluded_transparent kernel != twin: {label}")
        if not n_filtered:
            raise SystemExit(f"no ray is lit through glass: {label}")
        # (the d=3 scene is all glass: nothing there can block a ray)
        if label.startswith("glass") and not int(kb.sum()):
            raise SystemExit(f"no ray is blocked: {label}")
    point, dirs, ldist = tcases["glass global light"][4]
    dead = torch.zeros_like(ldist)
    kb, kf, kv = rk.occluded_transparent(gres, point, dirs, dead,
                                         ghit["pid"], gcfg.d)
    if bool(kb.any()) or bool(kv.any()) or not bool((kf == 1).all()):
        raise SystemExit("a dead wavefront was walked")
    dead_t_ms = time_cuda(lambda: rk.occluded_transparent(
        gres, point, dirs, dead, ghit["pid"], gcfg.d), 20)
    dead_t_bound, _by = walk_bound(gcfg.d, False, dead > 0, dead > 0,
                                   [0] * (gcfg.d + 1), garrs["res_neff"], 0,
                                   4, R * 5 + kv.numel() * 4)
    print(f"   dead wavefront: {R} inactive rays, kernel {dead_t_ms:.4f} ms "
          f"(wrapper included), bound {dead_t_bound:.4f} ms (bytes) "
          f"[{name_limit}]")
    done(t0)

    # The streaming kernels 2.5-2.8 at the mesh's full wavefronts (d = 3,
    # 4,054 chunks through the ring), each against its twin and against its
    # sibling for small pools on the same inputs.  A mesh walk takes
    # 0.1-0.4 s and its twin tens of seconds: three timed kernel calls, and
    # the twin's one call timed.
    slot_bytes = {opa: 512 * (3 * 3 + 3 + 1 + opa) for opa in (0, 1)}
    props = torch.cuda.get_device_properties(0)
    optin = getattr(props, "shared_memory_per_block_optin", 232448)
    per_sm = getattr(props, "shared_memory_per_multiprocessor", 233472)
    for opa, sb in slot_bytes.items():
        ring = min(8, (optin - 4096) // sb) * sb
        print(f"   ring at d = 3{' with opacity' if opa else ''}: "
              f"{ring // sb} slots of {sb} B, {ring / 1024:.1f} KiB; shared "
              f"memory lets {per_sm // (ring + 4096)} blocks of 512 threads "
              f"share an SM")

    t0 = phase("nearest_hit_hbm kernel vs twin")
    # the redesigned streaming walks as they launch at each d (primary
    # rays' shared variant): registers, spills, blocks an SM, ring slots
    stream_info = {}
    for kname in STREAMING:
        for d_ in range(3, 9):
            stream_info[kname, d_] = rk.stream_info(kname, d_, shared=True)
            print(f"   {kname} at d = {d_}: {stream_info[kname, d_]}")
    _f, _o, _t, moT, mdT, mpctx, mskip, mhit = primary(mesh, mcfg, marrs)
    mres = wf._res_dict(marrs)
    mbytes = pool_bytes(marrs)
    msine = -wf._dotT(mdT, mhit["normalT"])
    hmodes = {
        "mesh primary": (moT, mdT, mskip,
                         dict(order=mpctx["order"], sh=mpctx["sh_res"])),
        "mesh bounce": (mhit["pointT"], wf._unitT(
            mdT - mhit["normalT"] * (-2 * msine)[None, :]), mhit["pid"],
            dict(active=mhit["hit"] & (blk % 2 == 0))),
    }
    near_h = {}
    for label, (o_, d_, s_, kw) in hmodes.items():
        args = (mres, o_, d_, s_, 3)
        kt, ks, kv = rk.nearest_hit_hbm(*args, **kw)
        (pt, ps, pv), twin_ms = timed(
            lambda: rk.nearest_hit_hbm_ref(*args, **kw))
        rt, rs, rv = rk.nearest_hit(*args, **kw)
        torch.cuda.synchronize()
        diffs = dict(slot=int((ks != ps).sum()), t_bits=bit_diffs(kt, pt),
                     visits=int((kv != pv).sum()),
                     slot_vs_2_1=int((ks != rs).sum()),
                     t_bits_vs_2_1=bit_diffs(kt, rt),
                     visits_vs_2_1=int((kv != rv).sum()))
        err = float(torch.nan_to_num(torch.abs(kt - pt), nan=float("inf"))
                    .max())
        # in turns: 2.1, 2.5, 2.5, 2.1 (2.1 launches 2.5's body: the times
        # should agree, and the diffs above hold the two entries together)
        res_ms = time_cuda(lambda: rk.nearest_hit(*args, **kw), 3)
        ms = time_cuda(lambda: rk.nearest_hit_hbm(*args, **kw), 3)
        ms = (ms + time_cuda(lambda: rk.nearest_hit_hbm(*args, **kw), 3)) / 2
        res_ms = (res_ms + time_cuda(lambda: rk.nearest_hit(*args, **kw),
                                     3)) / 2
        read = kw.get("active", torch.ones_like(ks, dtype=torch.bool))
        need = read & (rk._scene_exit_T(o_, d_, mres["b_lo"],
                                        mres["b_hi"]) > 0)
        stages = nearest_stages(*args, kw, kt, kv)
        bound_ms, bound_by = walk_bound(
            3, "sh" in kw, need, read, stages, n_chunks, mbytes,
            int("active" in kw), R * 8 + kv.numel() * 4)
        near_h[label] = dict(ms=ms, plain_ms=twin_ms, bound_ms=bound_ms,
                             bound_by=bound_by, err=err, resident_ms=res_ms,
                             ratio_to_2_1=ms / res_ms,
                             live_blocks=int((kv > 0).sum()))
        print(f"   {label}: {R} rays, {int(need.sum())} to test, "
              f"{int((ks >= 0).sum())} hits, {int((kv > 0).sum())} live "
              f"blocks, visits/block {float(kv.float().mean()):.4f}; diffs "
              f"{json.dumps(diffs)}, max |dt| {err}; kernel 2.5 {ms:.4f} ms, "
              f"kernel 2.1 on the same inputs {res_ms:.4f} ms (the same "
              f"body since 2.1's redesign: an equality check, not 2.5's "
              f"yardstick), ratio 2.5/2.1 "
              f"{ms / res_ms:.4f}; twin {twin_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of the bound reached; "
              f"{stage_note(stages)} [{name_limit}]")
        if any(diffs.values()):
            raise SystemExit(f"nearest_hit_hbm != twin or kernel 2.1: "
                             f"{label}")
    # the all-chunks entry pass alone: every block live, every origin far
    # outside the pool's box and a start distance (init_t) no chunk is
    # within, so no block visits a chunk (the wrapper would start each ray
    # at its scene exit, and the mesh's chunk boxes fill the scene's box)
    far = torch.full((3, R), 10.0, device=dev)
    out = torch.full((3, R), 3 ** -0.5, device=dev)
    none = torch.full((R,), -1, dtype=torch.int32, device=dev)
    pw = rk._walk_inputs(mres, far, out, none, 3, None, None, None)
    pw["init_t"] = torch.full((R,), 1e-30, device=dev)
    pw["blive"] = torch.ones_like(pw["blive"])

    def entry_probe():
        err, got = rk._nearest_kernel("ntr_nearest_hit_hbm", pw, far.device)
        if err:
            raise SystemExit(f"the 2.5 entry-pass probe failed: {err}")
        return got

    kt, ks, kv = entry_probe()
    if bool(kv.any()) or bool((ks >= 0).any()):
        raise SystemExit("the 2.5 entry-pass probe visited a chunk")
    entry_n_ms = time_cuda(entry_probe, 5)
    print(f"   2.5 entry pass alone ({R // 512} live blocks x {n_chunks} "
          f"chunks): {entry_n_ms:.4f} ms, "
          f"{entry_n_ms / (R // 512) * 1e3:.3f} us a block [{name_limit}]")
    done(t0)

    t0 = phase("occluded_hbm kernel vs twin")
    for kname in STREAMING:
        if stream_info[kname, 3]["blocks_per_sm"] < 2:
            raise SystemExit(f"{kname}: fewer than two blocks an SM at d = 3")
    hcases = {
        "mesh point light": shadow_rays(marrs, mhit,
                                        light_pos=marrs["pl_pos"][0]),
        "mesh global light": shadow_rays(marrs, mhit,
                                         light_dir=marrs["gl_dir"][0]),
    }
    occ_h = {}
    for label, (point, dirs, ldist) in hcases.items():
        args = (mres, point, dirs, ldist, mhit["pid"], 3)
        kb, kv = rk.occluded_hbm(*args)
        (pb, pv), twin_ms = timed(lambda: rk.occluded_hbm_ref(*args))
        rb, rv = rk.occluded(*args)
        torch.cuda.synchronize()
        diffs = dict(blocked=int((kb != pb).sum()),
                     visits=int((kv != pv).sum()),
                     blocked_vs_2_2=int((kb != rb).sum()),
                     visits_vs_2_2=int((kv != rv).sum()))
        # 2.2 launches 2.6's body: the comparison checks equality, and 2.2
        # is no yardstick of 2.6's time
        ms = time_cuda(lambda: rk.occluded_hbm(*args), 3)
        stages, dealt = occlusion_stages(*args, kb, kv)
        bound_ms, bound_by = walk_bound(
            3, False, ldist > 0, ldist > 0, stages, n_chunks, mbytes, 4,
            R + kv.numel() * 4, early=kb)
        occ_h[label] = dict(ms=ms, plain_ms=twin_ms, bound_ms=bound_ms,
                            bound_by=bound_by, err=float(diffs["blocked"]),
                            live_blocks=int((kv > 0).sum()),
                            work_per_visit=dealt / max(int(kv.sum()), 1))
        print(f"   {label}: {R} rays, {int((ldist > 0).sum())} active, "
              f"{int(kb.sum())} blocked, live blocks {int((kv > 0).sum())}, "
              f"visits/block {float(kv.float().mean()):.4f}; diffs "
              f"{json.dumps(diffs)}; kernel 2.6 {ms:.4f} ms (kernel 2.2, "
              f"equal on the same inputs, launches the same body: no "
              f"yardstick); twin {twin_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of "
              f"the bound reached; pair tests dealt out "
              f"{occ_h[label]['work_per_visit']:.1f} a visit of 512 x 128 = "
              f"65536; {stage_note(stages)} [{name_limit}]")
        if any(diffs.values()):
            raise SystemExit(f"occluded_hbm != twin or kernel 2.2: {label}")
        if not 0 < int(kb.sum()) < int((ldist > 0).sum()):
            raise SystemExit(f"the mesh's shadow rays decide nothing: "
                             f"{label}")
    point, dirs, ldist = hcases["mesh global light"]
    dead = torch.zeros_like(ldist)
    kb, kv = rk.occluded_hbm(mres, point, dirs, dead, mhit["pid"], 3)
    if bool(kb.any()) or bool(kv.any()):
        raise SystemExit("a dead wavefront was walked")
    dead_h_ms = time_cuda(lambda: rk.occluded_hbm(mres, point, dirs, dead,
                                                  mhit["pid"], 3), 20)
    # the all-chunks entry pass alone: every block live, every origin far
    # outside the pool's box and a distance no chunk is within, so no
    # block visits a chunk
    far = torch.full_like(point, 10.0)
    tiny = torch.full_like(ldist, 1e-30)
    kb, kv = rk.occluded_hbm(mres, far, dirs, tiny, mhit["pid"], 3)
    if bool(kb.any()) or bool(kv.any()):
        raise SystemExit("the entry-pass probe visited a chunk")
    entry_ms = time_cuda(lambda: rk.occluded_hbm(mres, far, dirs, tiny,
                                                 mhit["pid"], 3), 5)
    print(f"   dead wavefront: {R} inactive rays, kernel {dead_h_ms:.4f} ms "
          f"(wrapper included); the entry pass alone ({R // 512} live "
          f"blocks x {n_chunks} chunks): {entry_ms:.4f} ms, "
          f"{entry_ms / (R // 512) * 1e3:.3f} us a block [{name_limit}]")
    for label, c, e_ms in [(k, c, entry_n_ms) for k, c in near_h.items()] \
            + [(k, c, entry_ms) for k, c in occ_h.items()]:
        share = e_ms * c["live_blocks"] / (R // 512) / c["ms"]
        print(f"   {label}: entry pass of its {c['live_blocks']} live blocks "
              f"~{100 * share:.1f}% of the kernel's {c['ms']:.4f} ms")
    done(t0)

    t0 = phase("nearest_hit_transparent_hbm kernel vs twin")
    _f, _o, _t, gmoT, gmdT, gmpctx, gmskip, gmhit = primary(gmesh, gmcfg,
                                                            gmarrs)
    gmres = wf._res_dict(gmarrs)
    gmbytes = pool_bytes(gmarrs, opacity=True)
    gmsine = -wf._dotT(gmdT, gmhit["normalT"])
    thmodes = {
        "glass mesh primary": (gmoT, gmdT, gmskip,
                               dict(order=gmpctx["order"],
                                    sh=gmpctx["sh_res"])),
        "glass mesh bounce": (gmhit["pointT"], wf._unitT(
            gmdT - gmhit["normalT"] * (-2 * gmsine)[None, :]), gmhit["pid"],
            dict(active=gmhit["hit"] & (blk % 2 == 0))),
    }
    near_th = {}
    for label, (o_, d_, s_, kw) in thmodes.items():
        args = (gmres, o_, d_, s_, 3, K)
        kt, ks, ktt, kts, kv = rk.nearest_hit_transparent_hbm(*args, **kw)
        (pt, ps, ptt, pts, pv), twin_ms = timed(
            lambda: rk.nearest_hit_transparent_hbm_ref(*args, **kw))
        replaced = rk.nearest_hit_transparent_hbm_ref.replaced
        rt, rs, rtt, rts, rv = rk.nearest_hit_transparent(*args, **kw)
        torch.cuda.synchronize()
        diffs = dict(slot=int((ks != ps).sum()), t_bits=bit_diffs(kt, pt),
                     tslot=int((kts != pts).sum()),
                     tt_bits=bit_diffs(ktt, ptt),
                     visits=int((kv != pv).sum()),
                     slot_vs_2_3=int((ks != rs).sum()),
                     t_bits_vs_2_3=bit_diffs(kt, rt))
        moved = int((kts != rts).any(dim=0).sum())
        err = max(float(torch.nan_to_num(
            torch.where(a.view(torch.int32) == b.view(torch.int32), 0.0,
                        torch.abs(a - b)), nan=float("inf")).max())
            for a, b in ((kt, pt), (ktt, ptt)))
        # in turns: 2.3, 2.7, 2.7, 2.3
        hbm = lambda: rk.nearest_hit_transparent_hbm(*args, **kw)
        one = lambda: rk.nearest_hit_transparent(*args, **kw)
        res_ms = time_cuda(one, 3)
        ms = (time_cuda(hbm, 3) + time_cuda(hbm, 3)) / 2
        res_ms = (res_ms + time_cuda(one, 3)) / 2
        read = kw.get("active", torch.ones_like(ks, dtype=torch.bool))
        need = read & (rk._scene_exit_T(o_, d_, gmres["b_lo"],
                                        gmres["b_hi"]) > 0)
        stages = nearest_stages(*args[:5], kw, kt, kv, K=K, grouped=True)
        bound_ms, bound_by = walk_bound(
            3, "sh" in kw, need, read, stages, n_chunks, gmbytes,
            int("active" in kw), R * 8 + K * R * 8 + kv.numel() * 4)
        filled = kts >= 0
        near_th[label] = dict(ms=ms, plain_ms=twin_ms, bound_ms=bound_ms,
                              bound_by=bound_by, err=err, resident_ms=res_ms,
                              ratio_to_2_3=ms / res_ms, replaced=replaced,
                              slots_moved=moved)
        print(f"   {label}: {R} rays, {int(need.sum())} to test, "
              f"{int((ks >= 0).sum())} opaque hits, {int(filled.sum())} "
              f"slots filled, {replaced} slots replaced, visits/block "
              f"{float(kv.float().mean()):.4f} (kernel 2.3's "
              f"{float(rv.float().mean()):.4f}); {moved} rays' slot "
              f"positions differ from kernel 2.3's; diffs "
              f"{json.dumps(diffs)}, max |dt| {err}; kernel 2.7 {ms:.4f} ms, "
              f"kernel 2.3 on the same inputs {res_ms:.4f} ms, ratio 2.7/2.3 "
              f"{ms / res_ms:.4f}; twin {twin_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of the bound reached; "
              f"{stage_note(stages)} [{name_limit}]")
        if any(diffs.values()):
            raise SystemExit(f"nearest_hit_transparent_hbm != twin, or t "
                             f"and opaque slot != kernel 2.3's: {label}")
        if not int(filled.sum()):
            raise SystemExit(f"no transparent slot was filled: {label}")
    done(t0)

    t0 = phase("occluded_transparent_hbm kernel vs twin")
    thcases = {
        "glass mesh point light": shadow_rays(
            gmarrs, gmhit, light_pos=gmarrs["pl_pos"][0]),
        "glass mesh global light": shadow_rays(
            gmarrs, gmhit, light_dir=gmarrs["gl_dir"][0]),
    }
    occ_th = {}
    for label, (point, dirs, ldist) in thcases.items():
        args = (gmres, point, dirs, ldist, gmhit["pid"], 3)
        kb, kf, kv = rk.occluded_transparent_hbm(*args)
        (pb, pf, pv), twin_ms = timed(
            lambda: rk.occluded_transparent_hbm_ref(*args))
        rb, rf, rv = rk.occluded_transparent(*args)
        torch.cuda.synchronize()
        diffs = dict(blocked=int((kb != pb).sum()),
                     filt_bits=bit_diffs(kf, pf),
                     visits=int((kv != pv).sum()),
                     blocked_vs_2_4=int((kb != rb).sum()),
                     filt_bits_vs_2_4=bit_diffs(kf, rf),
                     visits_vs_2_4=int((kv != rv).sum()))
        # 2.4 launches 2.8's body: the comparison checks equality, and 2.4
        # is no yardstick of 2.8's time
        ms = time_cuda(lambda: rk.occluded_transparent_hbm(*args), 3)
        stages, dealt = occlusion_stages(*args, kb, kv, filtered=True)
        bound_ms, bound_by = walk_bound(
            3, False, ldist > 0, ldist > 0, stages, n_chunks, gmbytes, 4,
            R * 5 + kv.numel() * 4, early=kb)
        n_filtered = int(((kf < 1) & ~kb).sum())
        occ_th[label] = dict(ms=ms, plain_ms=twin_ms, bound_ms=bound_ms,
                             bound_by=bound_by,
                             err=float(torch.abs(kf - pf).max()),
                             live_blocks=int((kv > 0).sum()),
                             work_per_visit=dealt / max(int(kv.sum()), 1))
        print(f"   {label}: {R} rays, {int((ldist > 0).sum())} active, "
              f"{int(kb.sum())} blocked, {n_filtered} unblocked behind "
              f"glass; diffs {json.dumps(diffs)}, live blocks "
              f"{int((kv > 0).sum())}, visits/block "
              f"{float(kv.float().mean()):.4f}; kernel 2.8 {ms:.4f} ms "
              f"(kernel 2.4, equal on the same inputs, launches the same "
              f"body: no yardstick); twin {twin_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of "
              f"the bound reached; pair tests dealt out "
              f"{occ_th[label]['work_per_visit']:.1f} a visit of 512 x 128 = "
              f"65536; {stage_note(stages)} [{name_limit}]")
        if any(diffs.values()):
            raise SystemExit(f"occluded_transparent_hbm != twin or kernel "
                             f"2.4: {label}")
        if not n_filtered or not int(kb.sum()):
            raise SystemExit(f"the glass mesh's shadow rays are neither "
                             f"blocked nor filtered: {label}")
    point, dirs, ldist = thcases["glass mesh global light"]
    dead = torch.zeros_like(ldist)
    kb, kf, kv = rk.occluded_transparent_hbm(gmres, point, dirs, dead,
                                             gmhit["pid"], 3)
    if bool(kb.any()) or bool(kv.any()) or not bool((kf == 1).all()):
        raise SystemExit("a dead wavefront was walked")
    dead_th_ms = time_cuda(lambda: rk.occluded_transparent_hbm(
        gmres, point, dirs, dead, gmhit["pid"], 3), 20)
    print(f"   dead wavefront: {R} inactive rays, kernel {dead_th_ms:.4f} "
          f"ms (wrapper included) [{name_limit}]")
    done(t0)

    # Kernels 2.9 and 2.10 at full wavefronts, each against its twin: the
    # grid walks of the 10-orthoplex (two 512-triangle tiles), the
    # 9-orthoplex (one) and a 16-D random pool (one), for other d; past
    # d = 16 (the wide bodies) the wide d=20 path's wavefronts and random
    # pools at WIDE_POOL_DS (one tile each).  A twin's one call takes
    # seconds: it is timed once.
    t0 = phase("grid nearest_hit kernel vs twin")
    # kernel 2.9 as it launches: registers, spills, blocks an SM, ring
    # slots, rays a thread, with the shared rows and without
    grid_info = {}
    for d_ in (9, 10, 16, 17, 20) + WIDE_POOL_DS[1:] + (128,):
        for shared in (True, False):
            grid_info[d_, shared] = gk.launch_info(d_, shared)
            print(f"   grid_nearest_hit at d = {d_}"
                  f"{' (shared rows)' if shared else ''}: "
                  f"{grid_info[d_, shared]}")
    _f, ocam_o, _t, ooT, odT, opctx, oskip, ohit = primary(orth, ocfg, oarrs)
    _f, o9cam_o, _t, o9oT, o9dT, o9pctx, o9skip, o9hit = primary(
        orth9, o9cfg, o9arrs)
    p16cam_o = torch.as_tensor(pool16._cam._origin, device=dev)
    p16oT = p16cam_o[:, None].expand(16, R).contiguous()
    p16dT = torch.as_tensor(aimed(pool16._cam._origin, simplices16, R),
                            device=dev)
    p16pctx = wf.primary_ctx(p16arrs, p16cfg, p16cam_o)
    p16hit = wf.trace_pool(p16arrs, p16cfg, p16oT, p16dT, skip,
                           shared_origin=p16cam_o, pctx=p16pctx)
    okern, o9kern, p16kern = (wf._kern_dict(a) for a in
                              (oarrs, o9arrs, p16arrs))
    osine = -wf._dotT(odT, ohit["normalT"])
    gmodes = {
        "orthoplex primary": (ocfg, oarrs, okern, ooT, odT, oskip,
                              dict(sh=opctx["sh_kern"])),
        # the frame's bounce wavefront: every ray, the misses' infinite
        # origins too, each skipping the surface it leaves
        "orthoplex bounce": (ocfg, oarrs, okern, ohit["pointT"], wf._unitT(
            odT - ohit["normalT"] * (-2 * osine)[None, :]), ohit["pid"], {}),
        "orthoplex9 primary": (o9cfg, o9arrs, o9kern, o9oT, o9dT, o9skip,
                               dict(sh=o9pctx["sh_kern"])),
        # shared-origin rays from the camera aimed at the simplices (few of
        # them cross the camera's 3-space)
        "random16 aimed": (p16cfg, p16arrs, p16kern, p16oT, p16dT, skip,
                           dict(sh=p16pctx["sh_kern"])),
    }
    # the wide bodies: the random pools' rays from the camera at -8 on axis
    # 2 aimed at their simplices, with the shared rows and with their own
    # origins, and the wide d=20 path's primary wavefront and its bounce
    # wavefront (the misses' rays start outside the pool: few live rays)
    wide_rays = {}
    for d_, (pts_, parrs_) in wide_pools.items():
        cam_ = torch.zeros((d_,), dtype=torch.float32, device=dev)
        cam_[2] = -8.0
        oT_ = cam_[:, None].expand(d_, R).contiguous()
        dT_ = torch.as_tensor(aimed(cam_.cpu().numpy(), pts_, R), device=dev)
        kern_ = wf._kern_dict(parrs_)
        wide_rays[d_] = (oT_, dT_)
        cfg_ = types.SimpleNamespace(d=d_)
        gmodes[f"random{d_} aimed"] = (
            cfg_, parrs_, kern_, oT_, dT_, skip,
            dict(sh=gk.shared_rows(kern_["gt"], kern_["ci"], cam_, d_)))
        gmodes[f"random{d_} own origins"] = (cfg_, parrs_, kern_, oT_, dT_,
                                             skip, {})
    _f, wcam_o, _t, woT, wdT, wpctx, wskip, whit = primary(wide, wcfg, warrs)
    wkern = wf._kern_dict(warrs)
    gmodes["wide20 primary"] = (wcfg, warrs, wkern, woT, wdT, wskip,
                                dict(sh=wpctx["sh_kern"]))
    wsine = -wf._dotT(wdT, whit["normalT"])
    gmodes["wide20 bounce"] = (wcfg, warrs, wkern, whit["pointT"], wf._unitT(
        wdT - whit["normalT"] * (-2 * wsine)[None, :]), whit["pid"], {})
    near_g = {}
    for label, (cfg_, arrs_, kern_, o_, d_, s_, kw) in gmodes.items():
        args = (kern_, o_, d_, s_, cfg_.d)
        kt, kid, ktl = gk.nearest_hit(*args, **kw)
        (pt, pid, ptl), twin_ms = timed(lambda: gk.nearest_hit_ref(*args,
                                                                   **kw))
        torch.cuda.synchronize()
        diffs = dict(ids=int((kid != pid).sum()), t_bits=bit_diffs(kt, pt),
                     tiles=int((ktl != ptl).sum()))
        err = float(torch.nan_to_num(
            torch.where(kt.view(torch.int32) == pt.view(torch.int32), 0.0,
                        torch.abs(kt - pt)), nan=float("inf")).max())
        ms = time_cuda(lambda: gk.nearest_hit(*args, **kw), 5)
        nj = arrs_["kern_gt"].shape[1] // 512
        read = torch.ones_like(kid, dtype=torch.bool)
        need = rk._scene_exit_T(o_, d_, kern_["b_lo"], kern_["b_hi"]) > 0
        bound_ms, bound_by = walk_bound(
            cfg_.d, "sh" in kw, need, read,
            grid_walk_stages(*args, ktl, sh=kw.get("sh"), t=kt), nj,
            grid_pool_bytes(arrs_), 0, R * 8 + ktl.numel() * 4)
        near_g[label] = dict(d=cfg_.d, ms=ms, plain_ms=twin_ms,
                             bound_ms=bound_ms, bound_by=bound_by, err=err,
                             tiles_per_block=float(ktl.float().mean()))
        if label.endswith("aimed") and cfg_.d >= gk.WIDE_D:
            # the hits, for the occlusion rays of kernel 2.10
            wide_rays[cfg_.d] += (kt, kid)
        print(f"   {label}: d={cfg_.d}, {R} rays, {int(need.sum())} to test, "
              f"{int((kid >= 0).sum())} hits, {int((ktl > 0).sum())} live "
              f"blocks, tiles/block {float(ktl.float().mean()):.4f} of {nj}; "
              f"diffs {json.dumps(diffs)}, max |dt| {err}; kernel {ms:.4f} "
              f"ms, twin {twin_ms:.4f} ms (one call), bound {bound_ms:.4f} ms "
              f"({bound_by}), {100 * bound_ms / ms:.1f}% of the bound "
              f"reached [{name_limit}]")
        if any(diffs.values()):
            raise SystemExit(f"grid nearest_hit kernel != twin: {label}")
        if not int((kid >= 0).sum()) and label != "wide20 bounce":
            raise SystemExit(f"no ray hits: {label}")
    done(t0)

    # kernel 2.10: shadow rays from the primary hits (misses inactive, each
    # skipping the surface it lies on) towards the point light (finite
    # distances), along the global light (REAL_MAX, unclamped, as the grid
    # branch sends it) and from a light at the camera: the engine casts a
    # point light's shadow ray from the point away from the light, so these
    # cross the body and most end blocked; then a wavefront without any
    # active ray
    t0 = phase("grid occluded kernel vs twin")
    # kernel 2.10 as it launches: registers, spills, blocks an SM, ring
    # slots, rays a thread
    occl_info = {}
    for d_ in (9, 10, 16, 17, 20) + WIDE_POOL_DS[1:] + (128,):
        occl_info[d_] = gk.launch_info(d_, walk="occluded")
        print(f"   grid_occluded at d = {d_}: {occl_info[d_]}")
    gcases = {
        "orthoplex point light": (ocfg, oarrs, okern, ohit, grid_shadow_rays(
            ohit, light_pos=oarrs["pl_pos"][0])),
        "orthoplex global light": (ocfg, oarrs, okern, ohit, grid_shadow_rays(
            ohit, light_dir=oarrs["gl_dir"][0])),
        "orthoplex camera light": (ocfg, oarrs, okern, ohit, grid_shadow_rays(
            ohit, light_pos=ocam_o)),
        "orthoplex9 global light": (o9cfg, o9arrs, o9kern, o9hit,
                                    grid_shadow_rays(
                                        o9hit, light_dir=o9arrs["gl_dir"][0])),
        "random16 global light": (p16cfg, p16arrs, p16kern, p16hit,
                                  grid_shadow_rays(
                                      p16hit, light_dir=p16arrs["gl_dir"][0])),
    }
    # the wide bodies: the random pools' aimed rays again, from the camera
    # to just past their nearest hit on even rays (blocked there, or
    # nearer) and to the hit on odd rays (an occluder at ldist does not
    # block), misses inactive; and the wide d=20 path's shadow rays along
    # its global light
    for d_, (pts_, parrs_) in wide_pools.items():
        oT_, dT_, kt_, kid_ = wide_rays[d_]
        even = torch.arange(R, device=dev) % 2 == 0
        ldist_ = torch.where(kid_ >= 0,
                             torch.where(even, next_up(kt_), kt_), 0.0)
        gcases[f"random{d_} through the hits"] = (
            types.SimpleNamespace(d=d_), parrs_, wf._kern_dict(parrs_),
            dict(pid=skip), (oT_, dT_, ldist_))
    gcases["wide20 global light"] = (wcfg, warrs, wkern, whit,
                                     grid_shadow_rays(
                                         whit, light_dir=warrs["gl_dir"][0]))
    occ_g = {}
    for label, (cfg_, arrs_, kern_, hit_, (point, dirs, ldist)) in \
            gcases.items():
        args = (kern_, point, dirs, ldist, hit_["pid"], cfg_.d)
        kb, ktl = gk.occluded(*args)
        (pb, ptl), twin_ms = timed(lambda: gk.occluded_ref(*args))
        torch.cuda.synchronize()
        diffs = dict(blocked=int((kb != pb).sum()),
                     tiles=int((ktl != ptl).sum()))
        ms = time_cuda(lambda: gk.occluded(*args), 5)
        nj = arrs_["kern_gt"].shape[1] // 512
        bound_ms, bound_by = walk_bound(
            cfg_.d, False, ldist > 0, ldist > 0,
            grid_walk_stages(kern_, point, dirs, hit_["pid"], cfg_.d, ktl,
                             ldist=ldist, blocked=kb), nj,
            grid_pool_bytes(arrs_), 4, R + ktl.numel() * 4, early=kb)
        occ_g[label] = dict(d=cfg_.d, ms=ms, plain_ms=twin_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            err=float(diffs["blocked"]),
                            tiles_per_block=float(ktl.float().mean()))
        print(f"   {label}: d={cfg_.d}, {R} rays, {int((ldist > 0).sum())} "
              f"active, {int(kb.sum())} blocked, live blocks "
              f"{int((ktl > 0).sum())}, tiles/block "
              f"{float(ktl.float().mean()):.4f} of {nj}; diffs "
              f"{json.dumps(diffs)}; kernel {ms:.4f} ms, twin {twin_ms:.4f} "
              f"ms (one call), bound {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of the bound reached "
              f"[{name_limit}]")
        if any(diffs.values()):
            raise SystemExit(f"grid occluded kernel != twin: {label}")
    point, dirs, ldist = gcases["orthoplex camera light"][4]
    kb, _ktl = gk.occluded(okern, point, dirs, ldist, ohit["pid"], 10)
    if not int(kb.sum()):
        raise SystemExit("no shadow ray crossing the orthoplex is blocked")
    point, dirs, ldist = gcases["orthoplex global light"][4]
    dead = torch.zeros_like(ldist)
    kb, ktl = gk.occluded(okern, point, dirs, dead, ohit["pid"], 10)
    if bool(kb.any()) or bool(ktl.any()):
        raise SystemExit("a dead wavefront was walked")
    dead_g_ms = time_cuda(lambda: gk.occluded(okern, point, dirs, dead,
                                              ohit["pid"], 10), 20)
    print(f"   dead wavefront: {R} inactive rays, kernel {dead_g_ms:.4f} ms "
          f"(wrapper included) [{name_limit}]")
    done(t0)

    # the post-walk glue kernel at the benchmark cells' frames: the
    # flagship 120-cell and the unlit orthoplex at 1920x1080 in 16 bits,
    # the unlit mesh at 1024x1024 in 8 bits
    t0 = phase("glue kernel vs plain")
    video = ImageFormat(1920, 1080, [Channel(16, 1, 0, 0),
                                     Channel(16, 0, 1, 0),
                                     Channel(16, 0, 0, 1)])
    unlit_mesh = nt3.build_composite_scene(mesh_protos)
    unlit_mesh.set_camera(mesh_camera)
    glue = glue_kernel([
        ("120-cell 1920x1080 16-bit", scene, video),
        ("orthoplex d=10 1920x1080 16-bit",
         orthoplex_scene(nt10, opaque, lit=False)[0], video),
        ("mesh d=3 1024x1024 8-bit", unlit_mesh, fmt)], dev, name_limit)
    done(t0)

    t0 = phase("flagship frame")
    renderer = nt_torch.BlockingRenderer()
    reset_launches()
    frame_s = orbit(nt, scene, camera, cam_distance, FRAMES, renderer, buf,
                    fmt)
    launches = {"flagship": read_launches()}
    print(f"   launches in {FRAMES + 1} renders: "
          f"{json.dumps(launches['flagship'])}")
    if launches["flagship"]["nearest_hit"] < FRAMES + 1:
        raise SystemExit("the flagship path did not go through nearest_hit")
    report_frames("flagship", frame_s, buf, name_limit)

    def stage_times(sc, cfg_, arrs_, extra, reps=5):
        """Where the device time goes, at the scene's camera (CUDA
        events).  ``extra`` maps the stage's context (the primary
        wavefront, its hits, the frame's rows) to more stages, or to
        another ``walk``."""
        fov_, cam_o_, cam_t_, oT_, dT_, pctx_, skip_, hit_ = primary(
            sc, cfg_, arrs_)
        grid, scan = wf._grid(arrs_), wf._scan(arrs_)
        res_ = wf._kern_dict(arrs_) if grid else \
            None if scan else wf._res_dict(arrs_)
        dyn = wf._scene_dyn(sc, dev)
        colorsT = wf._ray_colors_T(arrs_, cfg_, dyn, oT_, dT_, pctx=pctx_)
        ctx = dict(hit=hit_, oT=oT_, dT=dT_, skip=skip_, pctx=pctx_, dyn=dyn,
                   res=res_)
        if grid:
            walk = {"walk": lambda: gk.nearest_hit(res_, oT_, dT_, skip_,
                                                   cfg_.d,
                                                   sh=pctx_["sh_kern"])}
        elif scan:
            # the chunk scan has no kernel: its stage is "scan"
            walk = {}
        else:
            walk = {"walk": lambda: rk.nearest_hit(res_, oT_, dT_, skip_,
                                                   cfg_.d,
                                                   order=pctx_["order"],
                                                   sh=pctx_["sh_res"])}
        stages = {
            "raygen": lambda: wf.make_rays(cam_o_, cam_t_, *fov_, xs, ys),
            "frame_prep": lambda: wf.primary_ctx(arrs_, cfg_, cam_o_),
            **walk,
            **extra(ctx),
            "trace_shade": lambda: wf._ray_colors_T(arrs_, cfg_, dyn, oT_,
                                                    dT_, pctx=pctx_),
            "pack": lambda: wf.packing.pack_device_stream(
                colorsT, fmt_key, permute=_unswz),
            "device_frame": lambda: wf.frame_device_arrays(sc, fmt, dev),
        }
        stage_ms = {k: round(time_cuda(f, reps), 4)
                    for k, f in stages.items()}
        packed = wf.frame_device_arrays(sc, fmt, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(reps):
            packed.cpu()
        stage_ms["pull"] = round(1000 * (time.perf_counter() - t1) / reps, 4)
        return stage_ms

    def one_frame(sc):
        """Render one frame of ``sc``: (launch counts, host ms)."""
        reset_launches()
        t1 = time.perf_counter()
        if not renderer.render(buf, fmt, sc):
            raise SystemExit("render was aborted")
        return read_launches(), 1000 * (time.perf_counter() - t1)

    stage_ms = stage_times(scene, cfg, arrs, lambda c: {})
    print(f"   stage ms {json.dumps(stage_ms)} [{name_limit}]")
    done(t0)

    t0 = phase("lit frame")
    reset_launches()
    frame_s = orbit(nt6, lit, lit_camera, lit_distance, LIT_FRAMES, renderer,
                    buf, fmt)
    launches["lit"] = read_launches()
    print(f"   launches in {LIT_FRAMES + 1} renders: "
          f"{json.dumps(launches['lit'])}")
    if launches["lit"]["nearest_hit"] < LIT_FRAMES + 1 or \
            launches["lit"]["occluded"] < 3 * (LIT_FRAMES + 1):
        raise SystemExit("the lit path did not go through both kernels")
    report_frames("lit", frame_s, buf, name_limit)
    # back to the configuration's own view (the orbit ends a quarter turn
    # off it, where hardly a simplex is on screen) for the stage times and
    # the oracle
    lit_camera = nt6.Camera()
    lit_camera.translate(nt6.Vector.axis(2, lit_distance))
    lit.set_camera(lit_camera)

    def shadow_stage(arrs_, cfg_):
        """One ``occlusion`` call: the first point light's shadow query
        from the primary hits."""
        def stage(c):
            point, lv, ldist = shadow_rays(arrs_, c["hit"],
                                           light_pos=arrs_["pl_pos"][0])
            return {"shadow": lambda: wf.occlusion(
                arrs_, cfg_, point, lv, ldist, c["hit"]["pid"],
                clamp_exit=False)}
        return stage

    stage_ms = stage_times(lit, lcfg, larrs, shadow_stage(larrs, lcfg))
    print(f"   stage ms {json.dumps(stage_ms)} [{name_limit}]")
    done(t0)

    # the flagship's geometry under two lights: most ray blocks carry
    # shadow rays, and part of the frame lies in shadow
    t0 = phase("lit 120-cell frame")
    l120cfg, l120arrs, _flat = wf.get_device_scene(lit120, dev)
    reset_launches()
    frame_s = orbit(nt, lit120, lit120_camera, cam_distance, LIT_FRAMES,
                    renderer, buf, fmt)
    launches["lit 120-cell"] = read_launches()
    print(f"   launches in {LIT_FRAMES + 1} renders: "
          f"{json.dumps(launches['lit 120-cell'])}")
    if launches["lit 120-cell"]["nearest_hit"] < LIT_FRAMES + 1 or \
            launches["lit 120-cell"]["occluded"] < 2 * (LIT_FRAMES + 1):
        raise SystemExit("the lit 120-cell path did not go through both "
                         "kernels")
    report_frames("lit 120-cell", frame_s, buf, name_limit)
    stage_ms = stage_times(lit120, l120cfg, l120arrs,
                           shadow_stage(l120arrs, l120cfg))
    print(f"   stage ms {json.dumps(stage_ms)} [{name_limit}]")
    # a convex body casts no shadow on a face that looks at the light: one
    # frame of a scene whose triangles shade each other
    launches["shadows d=3"], ms = one_frame(shadows_d3)
    print(f"   shadows d=3: one frame {ms:.3f} ms (first render of the "
          f"scene), launches {json.dumps(launches['shadows d=3'])} "
          f"[{name_limit}]")
    if launches["shadows d=3"]["nearest_hit"] < 1 or \
            launches["shadows d=3"]["occluded"] < 2:
        raise SystemExit("the shadows d=3 frame did not go through both "
                         "kernels")
    done(t0)

    # the main path of the transparent walks: one K-slot walk and
    # (K + 1) x 2 filtered occlusion walks a frame
    t0 = phase("glass 120-cell frame")
    reset_launches()
    frame_s = orbit(nt, glass, glass_camera, cam_distance, LIT_FRAMES,
                    renderer, buf, fmt)
    launches["glass 120-cell"] = read_launches()
    print(f"   launches in {LIT_FRAMES + 1} renders: "
          f"{json.dumps(launches['glass 120-cell'])}")
    if launches["glass 120-cell"]["nearest_hit_transparent"] \
            < LIT_FRAMES + 1 or \
            launches["glass 120-cell"]["occluded_transparent"] \
            < (K + 1) * 2 * (LIT_FRAMES + 1):
        raise SystemExit("the glass 120-cell path did not go through both "
                         "transparent kernels")
    report_frames("glass 120-cell", frame_s, buf, name_limit)
    # an eager frame: a frame replayed from its graphs (engine/graphs.py)
    # calls the C entries from its record, not through _occlusion_kernel
    glass._torch_graphs = None
    live_t = live_launches("ntr_occluded_t",
                           lambda: renderer.render(buf, fmt, glass))
    print(f"   kernel 2.4 in one glass 120-cell frame: {live_t[0]} live "
          f"launches (a block visited a chunk), {live_t[1]} dead")

    def glass_stages(c):
        shadow = shadow_stage(garrs, gcfg)(c)
        base = torch.zeros_like(c["oT"][:3])
        return {
            "walk": lambda: rk.nearest_hit_transparent(
                c["res"], c["oT"], c["dT"], c["skip"], gcfg.d, K,
                order=c["pctx"]["order"], sh=c["pctx"]["sh_res"]),
            **shadow,
            "compose": lambda: wf._compose_transparent_T(
                garrs, gcfg, c["dyn"], c["oT"], c["dT"], c["hit"], base, 0),
        }

    stage_ms = stage_times(glass, gcfg, garrs, glass_stages)
    print(f"   stage ms {json.dumps(stage_ms)} [{name_limit}]")
    # one frame of the d=3 scene, where the K slots overflow
    launches["transparent d=3"], d3_ms = one_frame(d3)
    print(f"   transparent d=3: one frame {d3_ms:.3f} ms (first render of "
          f"the scene), launches "
          f"{json.dumps(launches['transparent d=3'])} [{name_limit}]")
    if launches["transparent d=3"]["nearest_hit_transparent"] < 1 or \
            launches["transparent d=3"]["occluded_transparent"] \
            < (K + 1) * 2:
        raise SystemExit("the d=3 frame did not go through both transparent "
                         "kernels")
    done(t0)

    def only(path, want):
        """Fail unless ``path`` launched exactly ``want`` of each walk (and
        none of the others)."""
        got = launches[path]
        bad = {n: got[n] for n in WALKS if got[n] != want.get(n, 0)}
        if bad:
            raise SystemExit(f"the {path} path launched {json.dumps(bad)}, "
                             f"wanted {json.dumps(want)}")

    # a pool over the line: one streaming walk and two streaming occlusion
    # walks a frame, none of the small pools' entries
    t0 = phase("mesh frame")
    reset_launches()
    frame_s = orbit(nt3, mesh, mesh_camera, MESH_DISTANCE, LIT_FRAMES,
                    renderer, buf, fmt)
    launches["mesh"] = read_launches()
    print(f"   launches in {LIT_FRAMES + 1} renders: "
          f"{json.dumps(launches['mesh'])}")
    only("mesh", {"nearest_hit_hbm": LIT_FRAMES + 1,
                  "occluded_hbm": 2 * (LIT_FRAMES + 1)})
    report_frames("mesh", frame_s, buf, name_limit)

    def mesh_stages(c):
        return {
            "walk": lambda: rk.nearest_hit_hbm(
                c["res"], c["oT"], c["dT"], c["skip"], 3,
                order=c["pctx"]["order"], sh=c["pctx"]["sh_res"]),
            **shadow_stage(marrs, mcfg)(c),
        }

    stage_ms = stage_times(mesh, mcfg, marrs, mesh_stages, reps=2)
    print(f"   stage ms {json.dumps(stage_ms)} [{name_limit}]")
    done(t0)

    # the glass mesh: one streaming K-slot walk and (K + 1) x 2 streaming
    # filtered occlusion walks a frame
    t0 = phase("glass mesh frame")
    reset_launches()
    frame_s = orbit(nt3, gmesh, gmesh_camera, MESH_DISTANCE, LIT_FRAMES,
                    renderer, buf, fmt)
    launches["glass mesh"] = read_launches()
    print(f"   launches in {LIT_FRAMES + 1} renders: "
          f"{json.dumps(launches['glass mesh'])}")
    only("glass mesh",
         {"nearest_hit_transparent_hbm": LIT_FRAMES + 1,
          "occluded_transparent_hbm": (K + 1) * 2 * (LIT_FRAMES + 1)})
    report_frames("glass mesh", frame_s, buf, name_limit)

    def glass_mesh_stages(c):
        base = torch.zeros_like(c["oT"][:3])
        return {
            "walk": lambda: rk.nearest_hit_transparent_hbm(
                c["res"], c["oT"], c["dT"], c["skip"], 3, K,
                order=c["pctx"]["order"], sh=c["pctx"]["sh_res"]),
            **shadow_stage(gmarrs, gmcfg)(c),
            "compose": lambda: wf._compose_transparent_T(
                gmarrs, gmcfg, c["dyn"], c["oT"], c["dT"], c["hit"], base, 0),
        }

    stage_ms = stage_times(gmesh, gmcfg, gmarrs, glass_mesh_stages, reps=2)
    print(f"   stage ms {json.dumps(stage_ms)} [{name_limit}]")
    done(t0)

    # the d > 8 path: one grid walk and two grid occlusion walks a frame (a
    # point and a global light), no chunk walk
    t0 = phase("orthoplex d=10 frame")
    reset_launches()
    frame_s = orbit(nt10, orth, orth_camera, -4.0, LIT_FRAMES, renderer, buf,
                    fmt)
    launches["orthoplex d=10"] = read_launches()
    print(f"   launches in {LIT_FRAMES + 1} renders: "
          f"{json.dumps(launches['orthoplex d=10'])}")
    only("orthoplex d=10", {"grid_nearest_hit": LIT_FRAMES + 1,
                            "grid_occluded": 2 * (LIT_FRAMES + 1)})
    report_frames("orthoplex d=10", frame_s, buf, name_limit)

    def grid_stages(c):
        point, ld, ldist = grid_shadow_rays(c["hit"],
                                            light_dir=oarrs["gl_dir"][0])
        return {"shadow": lambda: wf.occlusion(oarrs, ocfg, point, ld, ldist,
                                               c["hit"]["pid"])}

    stage_ms = stage_times(orth, ocfg, oarrs, grid_stages)
    print(f"   stage ms {json.dumps(stage_ms)} [{name_limit}]")
    # one frame of tpu_parity.py's random 10-D simplices
    launches["generic d=10"], ms = one_frame(generic)
    print(f"   generic d=10: one frame {ms:.3f} ms (first render of the "
          f"scene), launches {json.dumps(launches['generic d=10'])} "
          f"[{name_limit}]")
    only("generic d=10", {"grid_nearest_hit": 1, "grid_occluded": 2})
    done(t0)

    # past d = 16: the wide bodies of 2.9 and 2.10, one grid walk and two
    # grid occlusion walks a frame
    t0 = phase("wide d=20 frame")
    reset_launches()
    frame_s = orbit(nt20, wide, wide_camera, -4.0, LIT_FRAMES, renderer, buf,
                    fmt)
    launches["wide d=20"] = read_launches()
    print(f"   launches in {LIT_FRAMES + 1} renders: "
          f"{json.dumps(launches['wide d=20'])}")
    only("wide d=20", {"grid_nearest_hit": LIT_FRAMES + 1,
                       "grid_occluded": 2 * (LIT_FRAMES + 1)})
    report_frames("wide d=20", frame_s, buf, name_limit)

    def wide_stages(c):
        point, ld, ldist = grid_shadow_rays(c["hit"],
                                            light_dir=warrs["gl_dir"][0])
        return {"shadow": lambda: wf.occlusion(warrs, wcfg, point, ld, ldist,
                                               c["hit"]["pid"])}

    stage_ms = stage_times(wide, wcfg, warrs, wide_stages)
    print(f"   stage ms {json.dumps(stage_ms)} [{name_limit}]")
    # the paths of d <= 8 take no grid walk
    for path, got in launches.items():
        if path not in ("orthoplex d=10", "generic d=10", "wide d=20") and \
                any(got[n] for n in GRID):
            raise SystemExit(f"the {path} path launched a grid walk")
    done(t0)

    def solid_stage(arrs_, cfg_):
        """The solids of one trace: ``_solid_test`` of every solid on the
        primary wavefront (each trace and each shadow query of a frame
        runs them once)."""
        def stage(c):
            return {"solids": lambda: [
                wf._solid_test(arrs_, s_, c["oT"], c["dT"], cfg_.d)
                for s_ in range(cfg_.n_solids)]}
        return stage

    def walk_equals_twin(label, launch, ref, args, kw):
        """The path's primary walk on the card against its twin on the same
        inputs: every output bit for bit."""
        got, want = launch(*args, **kw), ref(*args, **kw)
        diffs = [int((a != b).sum()) if a.dtype != torch.float32
                 else bit_diffs(a, b) for a, b in zip(got, want)]
        print(f"   {label} primary walk vs its twin: {diffs} entries differ "
              f"in {len(got)} outputs of {args[1].shape[1]} rays")
        if any(diffs):
            raise SystemExit(f"the {label} walk differs from its twin")

    # solids on the chunk walks: kernels 2.1 and 2.2, each trace and shadow
    # query followed by the two solids' tests
    t0 = phase("solids d=4 frame")
    reset_launches()
    frame_s = orbit(nt4, sol4, sol4_camera, -7.0, LIT_FRAMES, renderer, buf,
                    fmt)
    launches["solids d=4"] = read_launches()
    print(f"   launches in {LIT_FRAMES + 1} renders: "
          f"{json.dumps(launches['solids d=4'])}")
    only("solids d=4", {"nearest_hit": LIT_FRAMES + 1,
                        "occluded": 2 * (LIT_FRAMES + 1)})
    report_frames("solids d=4", frame_s, buf, name_limit)

    def sol4_stages(c):
        return {**shadow_stage(s4arrs, s4cfg)(c),
                **solid_stage(s4arrs, s4cfg)(c)}

    stage_ms = stage_times(sol4, s4cfg, s4arrs, sol4_stages)
    print(f"   stage ms {json.dumps(stage_ms)} [{name_limit}]")
    _f, _co, _ct, s4oT, s4dT, s4pctx, s4skip, _h = primary(sol4, s4cfg,
                                                           s4arrs)
    walk_equals_twin("solids d=4", rk.nearest_hit, rk.nearest_hit_ref,
                     (wf._res_dict(s4arrs), s4oT, s4dT, s4skip, 4),
                     dict(order=s4pctx["order"], sh=s4pctx["sh_res"]))
    done(t0)

    # a glass solid in the K slots: kernels 2.3 and 2.4
    t0 = phase("glass solids d=3 frame")
    reset_launches()
    frame_s = orbit(nt3, gsol3, gsol3_camera, -8.0, LIT_FRAMES, renderer,
                    buf, fmt)
    launches["glass solids d=3"] = read_launches()
    print(f"   launches in {LIT_FRAMES + 1} renders: "
          f"{json.dumps(launches['glass solids d=3'])}")
    only("glass solids d=3",
         {"nearest_hit_transparent": LIT_FRAMES + 1,
          "occluded_transparent": (K + 1) * (LIT_FRAMES + 1)})
    report_frames("glass solids d=3", frame_s, buf, name_limit)

    def gsol3_stages(c):
        base = torch.zeros_like(c["oT"][:3])
        return {
            "walk": lambda: rk.nearest_hit_transparent(
                c["res"], c["oT"], c["dT"], c["skip"], 3, K,
                order=c["pctx"]["order"], sh=c["pctx"]["sh_res"]),
            **shadow_stage(gs3arrs, gs3cfg)(c),
            **solid_stage(gs3arrs, gs3cfg)(c),
            "compose": lambda: wf._compose_transparent_T(
                gs3arrs, gs3cfg, c["dyn"], c["oT"], c["dT"], c["hit"], base,
                0),
        }

    stage_ms = stage_times(gsol3, gs3cfg, gs3arrs, gsol3_stages)
    print(f"   stage ms {json.dumps(stage_ms)} [{name_limit}]")
    _f, _co, _ct, g3oT, g3dT, g3pctx, g3skip, g3hit = primary(
        gsol3, gs3cfg, gs3arrs)
    print(f"   glass solids d=3 primary: {int(g3hit['hit'].sum())} opaque "
          f"hits, {int((g3hit['pid'] >= gs3cfg.n_tris).sum())} on the "
          f"sphere; {int((g3hit['tidT'] >= 0).sum())} valid slots, "
          f"{int((g3hit['tidT'] >= gs3cfg.n_tris).sum())} the glass cube's")
    if not (g3hit["tidT"] >= gs3cfg.n_tris).any():
        raise SystemExit("the glass cube entered no K slot")
    walk_equals_twin("glass solids d=3", rk.nearest_hit_transparent,
                     rk.nearest_hit_transparent_ref,
                     (wf._res_dict(gs3arrs), g3oT, g3dT, g3skip, 3, K),
                     dict(order=g3pctx["order"], sh=g3pctx["sh_res"]))
    done(t0)

    # a solid beside a d > 8 body: kernels 2.9 and 2.10
    t0 = phase("solid orthoplex d=10 frame")
    reset_launches()
    frame_s = orbit(nt10, sorth, sorth_camera, -4.0, LIT_FRAMES, renderer,
                    buf, fmt)
    launches["solid orthoplex d=10"] = read_launches()
    print(f"   launches in {LIT_FRAMES + 1} renders: "
          f"{json.dumps(launches['solid orthoplex d=10'])}")
    only("solid orthoplex d=10", {"grid_nearest_hit": LIT_FRAMES + 1,
                                  "grid_occluded": 2 * (LIT_FRAMES + 1)})
    report_frames("solid orthoplex d=10", frame_s, buf, name_limit)

    def sorth_stages(c):
        point, ld, ldist = grid_shadow_rays(c["hit"],
                                            light_dir=soarrs["gl_dir"][0])
        return {"shadow": lambda: wf.occlusion(soarrs, socfg, point, ld,
                                               ldist, c["hit"]["pid"]),
                **solid_stage(soarrs, socfg)(c)}

    stage_ms = stage_times(sorth, socfg, soarrs, sorth_stages)
    print(f"   stage ms {json.dumps(stage_ms)} [{name_limit}]")
    _f, _co, _ct, sooT, sodT, sopctx, soskip, _h = primary(sorth, socfg,
                                                           soarrs)
    walk_equals_twin("solid orthoplex d=10", gk.nearest_hit,
                     gk.nearest_hit_ref,
                     (wf._kern_dict(soarrs), sooT, sodT, soskip, 10),
                     dict(sh=sopctx["sh_kern"]))
    done(t0)

    # a transparent pool of d > 8: the chunk scan (plain torch, no
    # kernel) for the trace and the shadow queries, a glass sphere in it
    t0 = phase("glass orthoplex d=10 frame")
    scans = {"trace": [], "shadow": []}

    def counting(fn, log):
        def run(*a, **k):
            out = fn(*a, **k)
            log.append(int(out[-1].sum()))
            return out
        return run

    trace_scan, occlusion_scan = wf.trace_scan, wf.occlusion_scan
    wf.trace_scan = counting(trace_scan, scans["trace"])
    wf.occlusion_scan = counting(occlusion_scan, scans["shadow"])
    try:
        launches["glass orthoplex d=10"], ms = one_frame(gorth)
    finally:
        wf.trace_scan, wf.occlusion_scan = trace_scan, occlusion_scan
    print(f"   glass orthoplex d=10: one frame {ms:.3f} ms (first render of "
          f"the scene), launches "
          f"{json.dumps(launches['glass orthoplex d=10'])} [{name_limit}]")
    only("glass orthoplex d=10", {})
    print(f"   chunk scans in the frame: {len(scans['trace'])} traces "
          f"({sum(scans['trace'])} chunk runs), {len(scans['shadow'])} shadow "
          f"queries ({sum(scans['shadow'])} chunk runs), in groups of "
          f"{wf.SCAN_RAYS} rays")
    if len(scans["trace"]) != 1 or len(scans["shadow"]) != 2 * (K + 1):
        raise SystemExit("the glass orthoplex frame did not take the chunk "
                         "scan for its trace and its shadows")
    px = np.frombuffer(bytes(buf), np.uint8).reshape(H, W, 3)
    print(f"   the frame: {int((px.max(axis=2) > 0).sum())} lit pixels, "
          f"mean byte {px.mean():.3f}")

    def gorth_stages(c):
        point, ld, ldist = grid_shadow_rays(c["hit"],
                                            light_dir=goarrs["gl_dir"][0])
        base = torch.zeros_like(c["oT"][:3])
        return {
            "scan": lambda: wf.trace_scan(goarrs, gocfg, c["oT"], c["dT"],
                                          c["skip"]),
            "shadow": lambda: wf.occlusion(goarrs, gocfg, point, ld, ldist,
                                           c["hit"]["pid"]),
            **solid_stage(goarrs, gocfg)(c),
            "compose": lambda: wf._compose_transparent_T(
                goarrs, gocfg, c["dyn"], c["oT"], c["dT"], c["hit"], base,
                0),
        }

    stage_ms = stage_times(gorth, gocfg, goarrs, gorth_stages, reps=1)
    print(f"   stage ms {json.dumps(stage_ms)} [{name_limit}]")
    # the card's scan against the CPU's on the frame's group of rays with
    # the most hits: the matrix products sum in another order (cuBLAS's,
    # TF32 off), so t may differ by ulps and a fuzz test at a simplex's
    # edge may flip
    _f, _co, _ct, gooT, godT, _p, goskip, gohit = primary(gorth, gocfg,
                                                          goarrs)
    g0 = wf.SCAN_RAYS * int(gohit["hit"].reshape(-1, wf.SCAN_RAYS)
                            .sum(dim=1).argmax())
    g = slice(g0, g0 + wf.SCAN_RAYS)
    cpu_arrs = {k: v.cpu() if torch.is_tensor(v) else v
                for k, v in goarrs.items()}
    on_card = wf.trace_scan(goarrs, gocfg, gooT[:, g], godT[:, g],
                            goskip[g])
    on_host = wf.trace_scan(cpu_arrs, gocfg, gooT[:, g].cpu(),
                         godT[:, g].cpu(), goskip[g].cpu())
    flips = int(((on_card[1].cpu() != on_host[1])
                 | (on_card[3].cpu() != on_host[3]).any(dim=0)).sum())
    hits = on_host[1] >= 0
    rel = float(((on_card[0].cpu() - on_host[0]).abs()
                 / on_host[0])[hits].max())
    print(f"   scan on the card vs the CPU, {wf.SCAN_RAYS} rays from ray "
          f"{g0}: {int(hits.sum())} hits, {flips} rays with another pid or "
          f"slot, t within {rel:.3e} relative, visits "
          f"{on_card[4].tolist()} / {on_host[4].tolist()}")
    if hits.sum() < 1000 or flips > wf.SCAN_RAYS // 1000 or rel > 1e-5:
        raise SystemExit("the card's chunk scan differs from the CPU's")
    done(t0)

    # the renderer front end at full width: CallbackRenderer against
    # BlockingRenderer on the flagship orbit and on lit_config, a
    # wide-channel format through both renderers, a strip
    t0 = phase("callback renderer")
    launches["callback renderer"] = front_end(nt, scene, cam_distance, lit,
                                              renderer, fmt, dev, name_limit)
    done(t0)

    # the repository's apps, unmodified, on the port through its launcher
    t0 = phase("apps")
    apps(f"{W}x{H}", name_limit)
    done(t0)

    t0 = phase("oracle")
    rng = np.random.RandomState(0)
    oracle_check(scene, wf.frame_colors(scene, W, H, dev),
                 [(int(rng.randint(W)), int(rng.randint(H)))
                  for _ in range(ORACLE_PIXELS)])
    # the lit frame is mostly background: three quarters of its pixels are
    # drawn from the ones that hit a surface.  The oracle's occlusion walk
    # keeps the reference's early-out, which misses occluders of a global
    # light; the engine is any-hit, so the check runs with the exact walk.
    kdnodes.OCCLUDES_EARLY_OUT = False
    colors, masks = wf.frame_colors(lit, W, H, dev, masks=True)
    print(f"   lit frame: {int(masks['hit'].sum())} pixels hit a surface")
    oracle_check(lit, colors, pick_pixels(
        rng, {"hit": 3 * ORACLE_PIXELS // 4, None: ORACLE_PIXELS // 4},
        masks))
    # The 120-cell frames are held to the oracle from an oblique camera.
    # The axis view is a mirror hyperplane of the polytope: whole 2-faces
    # lie in it, every ray through them meets two mirrored simplices
    # exactly on their common boundary, and the last bit decides which one
    # counts -- differently in the engine and the oracle, visibly so under
    # a light off the hyperplane or with two materials
    # (tests/test_torch_mirror_view.py shows that every pixel that differs
    # there is on such a ray).
    for sc_ in (lit120, glass_u):
        turn(nt, sc_, nt.Camera(), cam_distance, OBLIQUE)
    # the lit 120-cell: shadowed pixels, lit pixels of the body, any pixel.
    # A convex body's faces that look at a light are not shadowed: what is
    # blocked here are rays along a surface the light grazes.
    colors, masks = wf.frame_colors(lit120, W, H, dev, masks=True)
    pixels = pick_pixels(rng, {"shadowed": 24, "hit": 24, None: 16}, masks)
    n_shadowed = count_in(pixels, masks["shadowed"])
    print(f"   lit 120-cell frame: {int(masks['hit'].sum())} pixels hit the "
          f"body, {int(masks['shadowed'].sum())} of them are shadowed "
          f"({int((masks['shadowed'] & masks['grazing']).sum())} by a "
          f"grazing light); {n_shadowed} of the {len(pixels)} oracle pixels "
          f"are shadowed")
    if n_shadowed < 16:
        raise SystemExit("the lit 120-cell oracle covers too few shadowed "
                         "pixels")
    oracle_check(lit120, colors, pixels)
    # shadows d=3: pixels in a real shadow (a triangle between the surface
    # and a light that stands well above it)
    colors, masks = wf.frame_colors(shadows_d3, W, H, dev, masks=True)
    masks["cast"] = masks["shadowed"] & ~masks["grazing"]
    pixels = pick_pixels(rng, {"cast": 32, "hit": 16, None: 16}, masks)
    n_cast = count_in(pixels, masks["cast"])
    print(f"   shadows d=3 frame: {int(masks['hit'].sum())} pixels hit a "
          f"triangle, {int(masks['cast'].sum())} of them lie in a cast "
          f"shadow; {n_cast} of the {len(pixels)} oracle pixels do")
    if n_cast < 16:
        raise SystemExit("the shadows d=3 oracle covers too few shadowed "
                         "pixels")
    oracle_check(shadows_d3, colors, pixels)
    # the glass 120-cell, built unbatched: pixels seen through glass, pixels
    # lit through glass, shadowed pixels, any pixel
    colors, masks = wf.frame_colors(glass_u, W, H, dev, masks=True)
    pixels = pick_pixels(
        rng, {"layered": 24, "filtered": 16, "shadowed": 8, None: 16}, masks,
        exclude=masks["full"])
    n_layered = count_in(pixels, masks["layered"])
    n_filtered = count_in(pixels, masks["filtered"])
    print(f"   glass 120-cell frame: {int(masks['layered'].sum())} pixels "
          f"are seen through glass, {int(masks['filtered'].sum())} are lit "
          f"through glass, {int(masks['shadowed'].sum())} shadowed, "
          f"{int(masks['full'].sum())} fill all {K} slots (excluded); the "
          f"{len(pixels)} oracle pixels hold {n_layered} layered and "
          f"{n_filtered} filtered ones")
    if n_layered < 16 or n_filtered < 8:
        raise SystemExit("the glass oracle covers too few transparent "
                         "pixels")
    oracle_check(glass_u, colors, pixels, tol=ORACLE_TOL_GLASS)
    # the d=3 scene: a ray that fills all K slots may cross more glass than
    # it keeps, and legitimately differs from the oracle
    colors, masks = wf.frame_colors(d3, W, H, dev, masks=True)
    pixels = pick_pixels(rng, {"layered": 48, None: 16}, masks,
                         exclude=masks["full"])
    print(f"   transparent d=3 frame: {int(masks['layered'].sum())} pixels "
          f"are seen through glass, {int(masks['full'].sum())} fill all {K} "
          f"slots and are excluded from the oracle's pixels")
    oracle_check(d3, colors, pixels, tol=ORACLE_TOL_GLASS)
    # the mesh frames from the turned camera: the axis camera looks through
    # the sphere's polar holes, whose rims are slivers
    for sc_ in (mesh, gmesh):
        turn(nt3, sc_, nt3.Camera(), MESH_DISTANCE, OBLIQUE)
    t1 = time.perf_counter()
    colors, masks = wf.frame_colors(mesh, W, H, dev, masks=True)
    pixels = pick_pixels(rng, {"hit": 48, None: 16}, masks)
    print(f"   mesh frame: {int(masks['hit'].sum())} pixels hit the sphere, "
          f"{int(masks['shadowed'].sum())} shadowed "
          f"({int((masks['shadowed'] & masks['grazing']).sum())} by a "
          f"grazing light)")
    oracle_check(mesh, colors, pixels)
    t2 = time.perf_counter()
    colors, masks = wf.frame_colors(gmesh, W, H, dev, masks=True)
    t3 = time.perf_counter()
    pixels = pick_pixels(
        rng, {"layered": 24, "filtered": 16, "shadowed": 8, None: 16}, masks,
        exclude=masks["full"])
    n_layered = count_in(pixels, masks["layered"])
    n_filtered = count_in(pixels, masks["filtered"])
    print(f"   glass mesh frame: {int(masks['layered'].sum())} pixels are seen "
          f"through glass, {int(masks['filtered'].sum())} are lit through "
          f"glass, {int(masks['shadowed'].sum())} shadowed, "
          f"{int(masks['full'].sum())} fill all {K} slots (excluded); the "
          f"{len(pixels)} oracle pixels hold {n_layered} layered and "
          f"{n_filtered} filtered ones")
    if n_layered < 16 or n_filtered < 8:
        raise SystemExit("the glass mesh oracle covers too few transparent "
                         "pixels")
    oracle_check(gmesh, colors, pixels, tol=ORACLE_TOL_GLASS)
    print(f"   mesh oracle {t2 - t1:.2f} s, glass mesh oracle "
          f"{time.perf_counter() - t3:.2f} s ({ORACLE_WORKERS} processes)")
    # the d > 8 frames: the orthoplex from the turned camera (a convex body:
    # its shadowed pixels are grazing ones), the random simplices as
    # tpu_parity.py's camera sees them
    turn(nt10, orth, nt10.Camera(), -4.0, OBLIQUE)
    t1 = time.perf_counter()
    colors, masks = wf.frame_colors(orth, W, H, dev, masks=True)
    pixels = pick_pixels(rng, {"hit": 48, None: 16}, masks)
    print(f"   orthoplex d=10 frame: {int(masks['hit'].sum())} pixels hit the "
          f"body, {int(masks['shadowed'].sum())} shadowed "
          f"({int((masks['shadowed'] & masks['grazing']).sum())} by a "
          f"grazing light)")
    oracle_check(orth, colors, pixels)
    t2 = time.perf_counter()
    colors, masks = wf.frame_colors(generic, W, H, dev, masks=True)
    print(f"   generic d=10 frame: {int(masks['hit'].sum())} pixels hit a "
          f"simplex, {int(masks['shadowed'].sum())} shadowed")
    hit_px = {"hit": min(32, int(masks["hit"].sum()))}
    oracle_check(generic, colors, pick_pixels(
        rng, {**(hit_px if hit_px["hit"] else {}),
              None: ORACLE_PIXELS - hit_px["hit"]}, masks))
    print(f"   orthoplex oracle {t2 - t1:.2f} s, generic oracle "
          f"{time.perf_counter() - t2:.2f} s ({ORACLE_WORKERS} processes)")

    def solid_pixels(sc, cfg_, arrs_):
        """(H, W): pixels whose primary ray's nearest hit, or one of its K
        slots, is a solid's."""
        hit_ = primary(sc, cfg_, arrs_)[-1]
        on = hit_["pid"] >= cfg_.n_tris
        if "tidT" in hit_:
            on = on | (hit_["tidT"] >= cfg_.n_tris).any(dim=0)
        return _unswz(on)[:W * H].reshape(H, W).cpu().numpy()

    # the solid scenes from the turned camera, a third or more of the
    # pixels on a solid; the glass ones without the pixels whose rays fill
    # all K slots
    for label, sc_, nt_, dist_, cfg_, arrs_, quotas, tol in (
            ("solids d=4", sol4, nt4, -7.0, s4cfg, s4arrs,
             {"solid": 32, "hit": 16, None: 16}, ORACLE_TOL),
            ("glass solids d=3", gsol3, nt3, -8.0, gs3cfg, gs3arrs,
             {"solid": 20, "layered": 16, "filtered": 8, "shadowed": 8,
              None: 12}, ORACLE_TOL_GLASS),
            ("solid orthoplex d=10", sorth, nt10, -4.0, socfg, soarrs,
             {"solid": 24, "hit": 24, None: 16}, ORACLE_TOL),
            ("glass orthoplex d=10", gorth, nt10, -4.0, gocfg, goarrs,
             {"solid": 16, "layered": 16, "filtered": 8, "hit": 8,
              None: 16}, ORACLE_TOL_GLASS)):
        turn(nt_, sc_, nt_.Camera(), dist_, OBLIQUE)
        t1 = time.perf_counter()
        colors, masks = wf.frame_colors(sc_, W, H, dev, masks=True)
        masks["solid"] = solid_pixels(sc_, cfg_, arrs_)
        t2 = time.perf_counter()
        print(f"   {label} frame ({t2 - t1:.2f} s): "
              + ", ".join(f"{int(v.sum())} {k}" for k, v in masks.items()))
        oracle_check(sc_, colors, pick_pixels(
            rng, quotas, masks,
            exclude=masks["full"] if cfg_.has_transparency else None),
            tol=tol)
        print(f"   {label} oracle {time.perf_counter() - t2:.2f} s "
              f"({ORACLE_WORKERS} processes)")
    # the wide d=20 frame from its turned camera
    turn(nt20, wide, nt20.Camera(), -4.0, OBLIQUE)
    t1 = time.perf_counter()
    colors, masks = wf.frame_colors(wide, W, H, dev, masks=True)
    pixels = pick_pixels(rng, {"hit": 48, None: 16}, masks)
    print(f"   wide d=20 frame: {int(masks['hit'].sum())} pixels hit a "
          f"simplex, {int(masks['shadowed'].sum())} shadowed "
          f"({int((masks['shadowed'] & masks['grazing']).sum())} by a "
          f"grazing light)")
    oracle_check(wide, colors, pixels)
    print(f"   wide d=20 oracle {time.perf_counter() - t1:.2f} s "
          f"({ORACLE_WORKERS} processes)")
    done(t0)

    # the sharded paths: a mesh on the one card, its shards one after
    # another; the scenes' views are the oracle phase's
    t0 = phase("multi-device")
    multi_device(scene, [("lit 120-cell", lit120, 3, [(1, 2), (2, 2)]),
                         ("glass 120-cell", glass_u, 3, [(1, 2), (2, 2)]),
                         ("solids d=4", sol4, 3, [(1, 2), (2, 2)]),
                         ("orthoplex d=10", orth, 3, [(1, 2), (2, 2)]),
                         ("mesh", mesh, 1, [(1, 2)])],
                 renderer, fmt, dev, name_limit, launches)
    done(t0)

    t0 = phase("counters")
    stats = counters([("flagship", scene), ("lit", lit),
                      ("lit 120-cell", lit120), ("glass 120-cell", glass),
                      ("mesh", mesh), ("orthoplex d=10", orth),
                      ("glass orthoplex d=10", gorth)],
                     mesh_d3_scene(nt3, glass_m, 120), dev, name_limit)
    if stats["flagship"]["rays_traced"] != W * H:
        raise SystemExit("the flagship frame did not trace one ray a pixel")
    done(t0)

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "ntracer", "ntracer_tpu")]
    if bad:
        raise SystemExit(f"imported {bad}")
    if div_ops != DIV_OPS:
        raise SystemExit(f"the bound counts DIV_OPS = {DIV_OPS}, the card's "
                         f"division executes {div_ops}")

    def kernel_entry(name, source, replaces, path, cases, main_case,
                     wrapper=None, **more):
        """The kernels line's entry of one kernel; ``wrapper`` is the name
        of the wrapper that counts its launches (``name`` by default)."""
        c = cases[main_case]
        wrapper = wrapper or name
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[path][wrapper],
                "launches_by_path": {p: n[wrapper]
                                     for p, n in launches.items()},
                "max_abs_err": max(float(v["err"]) for v in cases.values()),
                "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": None, "cases": cases, **more}

    csrc = "ntracer_tpu_torch/csrc/"
    tpu = "ntracer_tpu/engine/resident_kernels.py:"
    kernels = [
        kernel_entry("nearest_hit", csrc + "nearest_hit.cu", tpu + "778",
                     "flagship", near, "primary", entry_ms=entry_1_ms,
                     redesigned=REDESIGNED,
                     launch={f"d={d_}{' shared' if sh_ else ''}": v
                             for (d_, sh_), v in near_info.items()}),
        kernel_entry("occluded", csrc + "occluded.cu", tpu + "1100",
                     "lit 120-cell", occ, "flagship point light",
                     dead_ms=dead_ms, redesigned=REDESIGNED,
                     launch={f"d={d_}": v for d_, v in occ_info.items()}),
        kernel_entry("nearest_hit_transparent",
                     csrc + "nearest_hit_transparent.cu", tpu + "1288",
                     "glass 120-cell", near_t, "glass primary",
                     redesigned=REDESIGNED,
                     launch={f"d={d_}{' shared' if sh_ else ''}": v
                             for (d_, sh_), v in t3_info.items()}),
        kernel_entry("occluded_transparent",
                     csrc + "occluded_transparent.cu", tpu + "1452",
                     "glass 120-cell", occ_t, "glass point light",
                     dead_ms=dead_t_ms, redesigned=REDESIGNED,
                     launch=t_info[gcfg.d],
                     live_launches_a_frame=live_t[0],
                     dead_launches_a_frame=live_t[1]),
        # the streaming variants of the same sources (STREAM), on
        # stream_walk.cuh's loop
        kernel_entry("nearest_hit_hbm", csrc + "nearest_hit.cu", tpu + "1754",
                     "mesh", near_h, "mesh primary", entry_ms=entry_n_ms,
                     redesigned=REDESIGNED,
                     launch=stream_info["nearest_hit_hbm", 3]),
        kernel_entry("occluded_hbm", csrc + "occluded.cu", tpu + "1963",
                     "mesh", occ_h, "mesh point light", dead_ms=dead_h_ms,
                     entry_ms=entry_ms, redesigned=REDESIGNED,
                     launch=stream_info["occluded_hbm", 3]),
        kernel_entry("nearest_hit_transparent_hbm",
                     csrc + "nearest_hit_transparent.cu", tpu + "2174",
                     "glass mesh", near_th, "glass mesh primary",
                     redesigned=REDESIGNED,
                     launch=stream_info["nearest_hit_transparent_hbm", 3]),
        kernel_entry("occluded_transparent_hbm",
                     csrc + "occluded_transparent.cu", tpu + "2383",
                     "glass mesh", occ_th, "glass mesh point light",
                     dead_ms=dead_th_ms, redesigned=REDESIGNED,
                     launch=stream_info["occluded_transparent_hbm", 3]),
    ]
    pallas = "ntracer_tpu/engine/pallas_kernels.py:"

    def by_body(cases, wide):
        """The cases of the templated bodies (d < WIDE_D) or the wide."""
        return {k: v for k, v in cases.items()
                if (v["d"] >= gk.WIDE_D) == wide}

    # the templated bodies (d <= 16) and, past d = 16, the wide bodies:
    # one wrapper each walk, so the wide entries count the wide d=20 path's
    # launches
    kernels += [
        kernel_entry("grid_nearest_hit", csrc + "grid_walk.cu",
                     pallas + "222", "orthoplex d=10",
                     by_body(near_g, False), "orthoplex primary",
                     redesigned=GRID_REDESIGNED,
                     launch={f"d={d_}{' shared' if sh_ else ''}": v
                             for (d_, sh_), v in grid_info.items()
                             if d_ < gk.WIDE_D}),
        kernel_entry("grid_occluded", csrc + "grid_walk.cu", pallas + "346",
                     "orthoplex d=10", by_body(occ_g, False),
                     "orthoplex global light", dead_ms=dead_g_ms,
                     redesigned=GRID_REDESIGNED,
                     launch={f"d={d_}": v for d_, v in occl_info.items()
                             if d_ < gk.WIDE_D}),
        kernel_entry("grid_nearest_hit_wide", csrc + "grid_walk.cu",
                     pallas + "222", "wide d=20", by_body(near_g, True),
                     "wide20 primary", wrapper="grid_nearest_hit",
                     body=WIDE_BODIES,
                     launch={f"d={d_}{' shared' if sh_ else ''}": v
                             for (d_, sh_), v in grid_info.items()
                             if d_ >= gk.WIDE_D}),
        kernel_entry("grid_occluded_wide", csrc + "grid_walk.cu",
                     pallas + "346", "wide d=20", by_body(occ_g, True),
                     "wide20 global light", wrapper="grid_occluded",
                     body=WIDE_BODIES,
                     launch={f"d={d_}": v for d_, v in occl_info.items()
                             if d_ >= gk.WIDE_D}),
        # no Pallas kernel: the JAX package left the chain to XLA's fusion
        kernel_entry("shade_pack", csrc + "shade_pack.cu", None, "flagship",
                     glue, "orthoplex d=10 1920x1080 16-bit"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
