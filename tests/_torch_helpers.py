"""Small scenes and engine pairs shared by the tests of ntracer_tpu_torch.

Every scene is built from a numpy seed by the scene API of one package:
``pkg=PORT`` (the default) builds it with ``ntracer_tpu_torch``'s own
``NTracer``/``Material``, ``pkg=JAX`` with ``ntracer_tpu``'s.  The two
packages' classes are distinct, so each engine gets a scene of its own
package, built from the same seed so both see identical geometry.  The
packages are imported by name inside the builders: this module itself
imports neither, so jax-free test files can use it.
"""

import importlib
import os
import sys
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The suite runs several pytest workers side by side.  With torch's default
# of one intra-op thread per core in each of them the cores are
# oversubscribed and the spinning thread pools slow every worker down many
# times over; the small test sizes gain little from threads anyway.
torch.set_num_threads(1)

PORT = "ntracer_tpu_torch"
JAX = "ntracer_tpu"


def api(pkg=PORT):
    """The scene API of one package: NTracer, Material, ImageFormat,
    Channel, LockedError."""
    render = importlib.import_module(pkg + ".render")
    wrapper = importlib.import_module(pkg + ".wrapper")
    return types.SimpleNamespace(
        NTracer=wrapper.NTracer, Material=render.Material,
        ImageFormat=render.ImageFormat, Channel=render.Channel,
        LockedError=render.LockedError)


def _smoke():
    """chip_smoke.py's polytope construction, shared with the tests."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return importlib.import_module("chip_smoke")


def random_scene(d=3, n=1200, seed=7, spread=0.6, material=None, dist=-8,
                 pkg=PORT):
    """``n`` random simplices around the origin, camera on axis 2."""
    a = api(pkg)
    nt = a.NTracer(d)
    mat = material or a.Material((1, 0.5, 0.5))
    rng = np.random.RandomState(seed)
    protos = []
    for _ in range(n):
        base = rng.uniform(-2, 2, d)
        pts = [nt.Vector(*(base + rng.uniform(-spread, spread, d)))
               for _ in range(d)]
        protos.append(nt.TrianglePrototype(pts, mat))
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, dist))
    scene.set_camera(cam)
    return scene


def _alternating(a, reflectivity=0.0):
    """Materials by index as tests/test_pallas.py mixes them: even opaque
    (a mirror with ``reflectivity``), odd glass."""
    solid = a.Material((0.3, 0.8, 0.5), reflectivity=reflectivity)
    glass = a.Material((1, 0.7, 0.7), opacity=0.4)
    return lambda i: glass if i % 2 else solid


def unbatched(pkg=PORT):
    """Context in which scenes of ``pkg`` are built without grouping
    triangles into batches (chip_smoke.unbatched): the scalar oracle records
    one transparent hit per batch per leaf, so only an unbatched scene's
    oracle keeps every transparent surface."""
    return _smoke().unbatched(importlib.import_module(pkg + ".kdtree"))


def two_lights(scene, nt, point=None):
    """The point and the global light of scripts/tpu_parity.py (the point
    light at ``point`` when given), shadows on."""
    return _smoke().two_lights(nt, scene, point or (0, 5) + (0,) * (
        nt.dimension - 2))


def glass_scene(n=600, seed=31, spread=0.4, all_glass=False, lit=False,
                reflectivity=0.0, pkg=PORT):
    """A 3-D scene of ``n`` random triangles, glass and opaque by turns
    (tests/test_pallas.py's mix), or all of one glass (scripts/
    tpu_parity.py's "transparent d=3"); ``lit`` adds two lights with
    shadows, ``reflectivity`` makes the opaque half mirrors."""
    a = api(pkg)
    nt = a.NTracer(3)
    if all_glass:
        glass = a.Material((0.7, 0.8, 1.0), opacity=0.45)
        mat = lambda i: glass
    else:
        mat = _alternating(a, reflectivity)
    rng = np.random.RandomState(seed)
    protos = []
    for i in range(n):
        base = rng.uniform(-2, 2, 3)
        pts = [nt.Vector(*(base + rng.uniform(-spread, spread, 3)))
               for _ in range(3)]
        protos.append(nt.TrianglePrototype(pts, mat(i)))
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, -8))
    scene.set_camera(cam)
    return two_lights(scene, nt) if lit else scene


def polytope_scene(symbol=(3, 3, 5), angle=0.6, dist=-4.0, pkg=PORT,
                   glass=False, lit=False):
    """A regular 4-D polytope's boundary (the 600-cell by default: 600
    simplices, several chunks), seen from an oblique camera; ``glass``
    makes every other simplex transparent, ``lit`` adds chip_smoke.py's two
    lights with shadows."""
    smoke = _smoke()
    a = api(pkg)
    nt = a.NTracer(len(symbol) + 1)
    protos = smoke.hull_prototypes(
        nt, smoke.polytope_vertices(list(symbol)),
        _alternating(a) if glass else a.Material((1, 0.5, 0.5)))
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, dist))
    a2 = (cam.axes[0] + cam.axes[1] + cam.axes[3]) * (1 / np.sqrt(3))
    cam.transform(nt.Matrix.rotation(cam.axes[2], a2, angle))
    cam.normalize()
    cam.origin = cam.axes[2] * dist
    scene.set_camera(cam)
    return two_lights(scene, nt, (0, 3, -3, 1)) if lit else scene


class _Stand:
    """A stand-in scene for ``chip_smoke.turn`` before the scene exists."""

    def set_camera(self, camera):
        pass


def orthoplex_scene(d=10, pkg=PORT, reflectivity=0.0, companion=None,
                    angle=0.6, glass=False):
    """chip_smoke.py's orthoplex of dimension ``d`` (its camera at -4 on
    axis 2, fov 0.8, its two lights, shadows on) seen from the camera turned
    by ``angle`` (the axis view is a mirror hyperplane of the polytope).
    ``glass`` makes every other simplex of glass (``_alternating``).
    ``reflectivity`` > 0 makes every surface a mirror and the reflection
    depth 2.  ``companion`` adds a second body: ``"shade"`` an orthoplex of
    0.4 the size in the view beside the first, along the global light's
    shadow rays, so that it casts a shadow on it; ``"floor"`` one large
    simplex in the hyperplane y = -1 under it (a regular (d-1)-simplex of
    circumradius 30), so that reflections go from one to the other (in a
    scene of more than three dimensions a ray reflected off a body leaves
    the view's 3-space, and misses a small body there)."""
    smoke = _smoke()
    a = api(pkg)
    nt = a.NTracer(d)
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, -4.0))
    smoke.turn(nt, _Stand(), camera, -4.0, angle)
    verts = smoke.polytope_vertices([3] * (d - 2) + [4])
    simplices = [smoke.hull_simplices(verts)]
    if companion == "shade":
        # the point (0.9, 0, -0.3, 0, ...) projected into the view's 3-space
        axes = np.array([[camera.axes[i][c] for c in range(d)]
                         for i in range(3)])
        p = np.zeros(d)
        p[[0, 2]] = 0.9, -0.3
        simplices.append(smoke.hull_simplices(0.4 * verts
                                              + axes.T @ (axes @ p)))
    elif companion == "floor":
        unit = smoke.polytope_vertices([3] * (d - 2))       # (d, d - 1)
        simplices.append(np.insert(30 * unit, 1, -1.0, axis=1)[None])
    else:
        assert companion is None
    pts = np.concatenate(simplices).astype(np.float32)
    mat = a.Material((1, 0.5, 0.5), reflectivity=reflectivity)
    mats = [_alternating(a, reflectivity)(i) for i in range(len(pts))] \
        if glass else [mat] * len(pts)
    scene = nt.build_composite_scene(
        nt.TrianglePrototype.batch_from_points(pts, mats))
    scene.set_camera(camera)
    scene.set_fov(0.8)
    smoke.two_lights(nt, scene, (0, 3, -3, 1) + (0,) * (d - 4))
    if reflectivity:
        scene.set_max_reflect_depth(2)
    return scene


def generic_scene(pkg=PORT):
    """chip_smoke.py's "generic d=10" (scripts/tpu_parity.py's 40 random
    10-D simplices, ``force_generic``, under two lights)."""
    a = api(pkg)
    return _smoke().generic_scene(a.NTracer(10, force_generic=True),
                                  a.Material((0.8, 0.5, 0.9)))


def solids_d4_scene(pkg=PORT):
    """chip_smoke.py's "solids d=4": scripts/tpu_parity.py's cube, sphere
    and 12 triangles in one leaf, under the two lights with shadows."""
    a = api(pkg)
    return _smoke().solids_d4_scene(a.NTracer(4), a.Material)[0]


def glass_solids_d3_scene(pkg=PORT):
    """chip_smoke.py's "glass solids d=3": tests/test_engine.py's 600
    triangles (one in ten of glass), glass cube and opaque sphere in one
    leaf, a point light, shadows on."""
    a = api(pkg)
    return _smoke().glass_solids_d3_scene(a.NTracer(3), a.Material)[0]


def solids_only_scene(pkg=PORT, glass=False):
    """tests/test_engine.py's solids-only scene (a unit cube at the origin
    and a unit sphere at (2.5, 0, 0), no triangle) hand-built into one
    leaf; ``glass`` makes the cube of glass (opacity 0.5) and adds a global
    light along +x with shadows, so that the cube filters the light on the
    sphere."""
    smoke = _smoke()
    a = api(pkg)
    nt = a.NTracer(3)
    mat = a.Material((1, 0.5, 0.2))
    cube = a.Material((0.4, 0.9, 0.6), opacity=0.5) if glass else mat
    protos = [
        nt.SolidPrototype(smoke.CUBE, nt.Vector(0, 0, 0),
                          nt.Matrix.identity(), cube),
        nt.SolidPrototype(smoke.SPHERE, nt.Vector(2.5, 0, 0),
                          nt.Matrix.identity(), mat)]
    scene = smoke.leaf_scene(nt, protos, 4.0)
    cam = nt.Camera()
    cam.translate(nt.Vector(0.2, 0.1, -9))
    scene.set_camera(cam)
    if glass:
        scene.add_light(nt.GlobalLight(nt.Vector(1, 0.1, 0.2), (1, 0.8, 0.6)))
        scene.set_shadows(True)
    return scene


def solid_orthoplex_scene(d=10, pkg=PORT, glass=False, angle=0.6):
    """chip_smoke.py's "solid orthoplex" (``glass`` False: an opaque cube
    beside the orthoplex) or "glass orthoplex" (every other simplex of glass
    and a glass sphere beside it) of dimension ``d``, seen from the camera
    turned by ``angle``."""
    smoke = _smoke()
    a = api(pkg)
    nt = a.NTracer(d)
    if glass:
        scene, camera, _n = smoke.solid_orthoplex_scene(
            nt, a.Material((0.3, 0.8, 0.5)),
            a.Material((0.5, 0.9, 0.9), opacity=0.4),
            glass=a.Material((1, 0.7, 0.7), opacity=0.4))
    else:
        scene, camera, _n = smoke.solid_orthoplex_scene(
            nt, a.Material((1, 0.5, 0.5)), a.Material((0.4, 0.9, 0.6)))
    smoke.turn(nt, scene, camera, -4.0, angle)
    return scene


def reflective_scene(seed=9, shadows=False, pkg=PORT):
    """A 3-D scene with reflective material, a point and a global light:
    the bounce loop runs its bounce traces (and, with ``shadows``, its
    occlusion walks from the bounce hits)."""
    a = api(pkg)
    nt = a.NTracer(3)
    scene = random_scene(3, n=300, seed=seed, spread=0.8,
                         material=a.Material((1, 0.6, 0.4), reflectivity=0.4,
                                             specular_intensity=0.5,
                                             specular_exp=8), pkg=pkg)
    scene.add_light(nt.PointLight(nt.Vector(0, 4, -4), (1, 0.8, 0.6)))
    scene.add_light(nt.GlobalLight(nt.Vector(0.3, -1, 0.2), (0.3, 0.3, 0.3)))
    scene.set_ambient_color((0.05, 0.05, 0.05))
    scene.set_shadows(shadows)
    return scene


def lit_scene(d=6, n=200, seed=3, off_view=0.15, pkg=PORT):
    """The lit configuration of chip_smoke.py (``lit_scene`` there: random
    simplices, two point lights, one global light, shadows on, camera at -8
    on axis 2) with ``n`` simplices.  At the configuration's own spread a
    6-D scene of 200 simplices leaves a small frame empty, so the tests
    gather the simplices around the viewed 3-space: ``off_view`` scales
    their positions along the axes the camera does not see (3 and up)."""
    a = api(pkg)
    nt = a.NTracer(d)
    mat = a.Material((0.9, 0.6, 0.3))
    rng = np.random.RandomState(seed)
    protos = []
    for _ in range(n):
        base = rng.uniform(-2, 2, d)
        base[3:] *= off_view
        pts = [nt.Vector(*(base + rng.uniform(-0.7, 0.7, d)))
               for _ in range(d)]
        protos.append(nt.TrianglePrototype(pts, mat))
    scene = nt.build_composite_scene(protos)
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, -8.0))
    scene.set_camera(camera)
    scene.add_light(nt.PointLight(nt.Vector.axis(1, 5), (1, 0.9, 0.7)))
    scene.add_light(nt.PointLight(nt.Vector.axis(0, -5), (0.4, 0.5, 0.9)))
    scene.add_light(nt.GlobalLight(nt.Vector.axis(1, -1), (0.2, 0.2, 0.3)))
    scene.set_shadows(True)
    return scene


def mirror_scene_1500(pkg=PORT):
    """tests/test_pallas.py's scene over the JAX package's pool line (its
    ``test_hbm_resident_path_matches_xla``): 1,500 random 3-D triangles of
    a reflective material (0.3), a point light, shadows on."""
    a = api(pkg)
    nt = a.NTracer(3)
    mat = a.Material((1, 0.6, 0.4), reflectivity=0.3)
    rng = np.random.RandomState(9)
    protos = []
    for _ in range(1500):
        base = rng.uniform(-2, 2, 3)
        pts = [nt.Vector(*(base + rng.uniform(-0.4, 0.4, 3)))
               for _ in range(3)]
        protos.append(nt.TrianglePrototype(pts, mat))
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, -8))
    scene.set_camera(cam)
    scene.add_light(nt.PointLight(nt.Vector(0, 4, -4), (1, 0.8, 0.6)))
    scene.set_shadows(True)
    return scene


def lit_scene_3d(seed=5, pkg=PORT):
    """A 3-D scene of 1,200 triangles with a point and a global light and
    shadows on."""
    a = api(pkg)
    nt = a.NTracer(3)
    scene = random_scene(3, n=1200, seed=seed, pkg=pkg)
    scene.add_light(nt.PointLight(nt.Vector(1, 5, -3), (1, 0.9, 0.7)))
    scene.add_light(nt.GlobalLight(nt.Vector(0.2, -1, 0.3), (0.3, 0.3, 0.4)))
    scene.set_shadows(True)
    return scene


def rgb8(w, h, pkg=PORT):
    a = api(pkg)
    return a.ImageFormat(w, h, [a.Channel(8, 1, 0, 0), a.Channel(8, 0, 1, 0),
                                a.Channel(8, 0, 0, 1)])


def formats(w, h, pkg=PORT):
    """The pixel formats the frame tests pack: 8-bit RGB, 16-bit RGB,
    reversed RGBA, float RGB and 5-6-5."""
    a = api(pkg)
    ImageFormat, Channel = a.ImageFormat, a.Channel
    return {
        "rgb8": rgb8(w, h, pkg),
        "rgb48": ImageFormat(w, h, [Channel(16, 1, 0, 0),
                                    Channel(16, 0, 1, 0),
                                    Channel(16, 0, 0, 1)]),
        "bgra_reversed": ImageFormat(
            w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                   Channel(8, 0, 0, 1), Channel(8, 0, 0, 0, 1)],
            reversed=True),
        "float": ImageFormat(w, h, [Channel(32, 1, 0, 0, tfloat=True),
                                    Channel(32, 0, 1, 0, tfloat=True),
                                    Channel(32, 0, 0, 1, tfloat=True)]),
        "rgb565": ImageFormat(w, h, [Channel(5, 1, 0, 0),
                                     Channel(6, 0, 1, 0),
                                     Channel(5, 0, 0, 1)]),
    }


def jax_device_scene(scene, monkeypatch):
    """The JAX engine's device scene (of a ``pkg=JAX`` scene) with the Pallas
    layouts (built on the CPU only under NTRACER_FORCE_KERNELS), as numpy
    arrays."""
    from ntracer_tpu.engine import wavefront as jwf
    monkeypatch.setenv("NTRACER_FORCE_KERNELS", "1")
    cfg, device, flat = jwf.get_device_scene(scene)
    return cfg, {k: np.asarray(v) for k, v in device.items()}, flat
