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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def polytope_scene(symbol=(3, 3, 5), angle=0.6, dist=-4.0, pkg=PORT):
    """A regular 4-D polytope's boundary (the 600-cell by default: 600
    simplices, several chunks), seen from an oblique camera."""
    smoke = _smoke()
    a = api(pkg)
    nt = a.NTracer(len(symbol) + 1)
    protos = smoke.hull_prototypes(nt, smoke.polytope_vertices(list(symbol)),
                                   a.Material((1, 0.5, 0.5)))
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, dist))
    a2 = (cam.axes[0] + cam.axes[1] + cam.axes[3]) * (1 / np.sqrt(3))
    cam.transform(nt.Matrix.rotation(cam.axes[2], a2, angle))
    cam.normalize()
    cam.origin = cam.axes[2] * dist
    scene.set_camera(cam)
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
