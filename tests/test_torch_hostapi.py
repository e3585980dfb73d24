"""The port's own copy of the host scene API against the JAX package's, on
seeded inputs: vector, matrix and camera arithmetic, image formats, scene
building and flattening, the scalar oracle and pickles.  Everything here is
numpy on the host, so results are equal bit for bit."""

import pickle

import numpy as np
import pytest

import ntracer_tpu_torch
from ntracer_tpu.engine import flatten as jflat
from ntracer_tpu.engine import packing as jpack
from ntracer_tpu_torch.engine import flatten as pflat
from ntracer_tpu_torch.engine import packing as ppack

from _torch_helpers import (JAX, PORT, api, formats, random_scene,
                            polytope_scene, lit_scene, reflective_scene)

PKGS = (JAX, PORT)


def _arr(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else list(x),
                      np.float32)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b, equal_nan=True), what


@pytest.mark.parametrize("d", [3, 4, 6, 8])
def test_vector_matrix_camera_arithmetic(d):
    rng = np.random.RandomState(d)
    va, vb = rng.uniform(-2, 2, (2, d))
    theta = float(rng.uniform(0.1, 1.5))
    out = []
    for pkg in PKGS:
        nt = api(pkg).NTracer(d)
        a, b = nt.Vector(*va), nt.Vector(*vb)
        m = nt.Matrix.rotation(a.unit(), nt.Vector.axis(1), theta)
        s = nt.Matrix.scale(1.5)
        cam = nt.Camera()
        cam.translate(a)
        cam.transform(m)
        cam.normalize()
        cam.origin = cam.axes[2] * -4.0
        res = {
            "add": a + b, "sub": a - b, "neg": -a, "mul": a * 2.5,
            "div": a / 3.0, "unit": a.unit(), "mv": m * b,
            "axis": nt.Vector.axis(d - 1, 2),
            "mm": m * s, "mt": m.mult_transpose(s), "inv": m.inverse(),
            "tr": m.transpose(), "refl": nt.Matrix.reflection(a.unit()),
            "cam_o": cam.origin, "cam_r": cam.right(), "cam_u": cam.up(),
            "cam_f": cam.forward(), "cam_a3": cam.axes[d - 1],
            "cross": nt.cross([nt.Vector.axis(i) + a * 0.1
                               for i in range(d - 1)]),
        }
        res = {k: _arr(v) for k, v in res.items()}
        res.update(dot=np.float32(nt.dot(a, b)), abs=np.float32(a.absolute()),
                   sq=np.float32(a.square()),
                   det=np.float32(m.determinant()))
        assert type(a).__module__ == pkg + ".api"
        assert nt.base.__name__ == f"{pkg}.tracer{d}"
        out.append(res)
    assert sorted(out[0]) == sorted(out[1])
    for k in out[0]:
        _same(out[0][k], out[1][k], k)


@pytest.mark.parametrize("name", sorted(formats(1, 1)))
def test_image_format_pitch_and_key(name):
    f = [formats(37, 5, pkg)[name] for pkg in PKGS]
    assert f[0].pitch == f[1].pitch and f[0].pitch >= 37 * f[0].bytes_per_pixel
    assert f[0].bytes_per_pixel == f[1].bytes_per_pixel
    assert len(f[0].channels) == len(f[1].channels)
    assert repr(list(f[0].channels)) == repr(list(f[1].channels))
    key = ppack.format_key(f[1])
    assert key == jpack.format_key(f[0]) == ppack.format_key(f[0])
    for pkg in PKGS:
        a = api(pkg)
        wide = a.ImageFormat(10, 2, [a.Channel(8, 1, 0, 0)], pitch=16)
        assert wide.pitch == 16
        with pytest.raises(ValueError):
            a.ImageFormat(10, 2, [a.Channel(8, 1, 0, 0)], pitch=4)
        with pytest.raises(ValueError):
            a.Channel(32, 1, 0, 0)


SCENES = {
    "3d": lambda pkg: random_scene(3, n=300, seed=11, pkg=pkg),
    "4d": lambda pkg: polytope_scene(pkg=pkg),
    "6d_lit": lambda pkg: lit_scene(6, n=200, pkg=pkg),
    "3d_reflective_lit": lambda pkg: reflective_scene(shadows=True, pkg=pkg),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scenes(request):
    return [SCENES[request.param](pkg) for pkg in PKGS]


def _tree(node):
    """A k-d tree as nested tuples: axis, split and leaf sizes."""
    if node is None:
        return None
    if hasattr(node, "axis"):
        return (node.axis, np.float32(node.split), _tree(node.left),
                _tree(node.right))
    return len(node)


def test_built_scene_and_flatten_match(scenes):
    js, ps = scenes
    assert type(ps).__module__ == "ntracer_tpu_torch.scene"
    assert type(js).__module__ == "ntracer_tpu.scene"
    _same(_arr(js.boundary.start), _arr(ps.boundary.start), "boundary start")
    _same(_arr(js.boundary.end), _arr(ps.boundary.end), "boundary end")
    assert _tree(js.root) == _tree(ps.root)
    ref = jflat.flatten_composite(js, chunk=512)
    got = pflat.flatten_composite(ps, chunk=512)
    assert sorted(got.arrays) == sorted(ref.arrays)
    for k in ref.arrays:
        _same(got.arrays[k], ref.arrays[k], k)
    assert got.config.shadows == ref.config.shadows == bool(ps.shadows)
    assert got.config.n_point_lights == len(ps.point_lights)


def test_oracle_pixels_match(scenes):
    """The scalar oracle is copied too: the same pixels, bit for bit."""
    js, ps = scenes
    w = h = 48
    for s in scenes:
        s._set_view_size(w, h)
    rng = np.random.RandomState(5)
    lit = 0
    for _ in range(12):
        x, y = int(rng.randint(w)), int(rng.randint(h))
        a, b = js._pixel_color(x, y), ps._pixel_color(x, y)
        _same(a, b, f"pixel ({x}, {y})")
        c = ps.calculate_color(x, y, w, h)
        assert type(c).__module__ == "ntracer_tpu_torch.render"
        _same(np.asarray(list(c), np.float32), b, "calculate_color")
        lit += bool(np.any(b != ps._pixel_color(0, 0)))
    assert lit > 0


def test_scene_api_contract(scenes):
    """Locks, mutation and copies behave as in the JAX package."""
    for pkg, s in zip(PKGS, scenes):
        a = api(pkg)
        c = s.__copy__()
        assert type(c) is type(s) and c.shadows == s.shadows
        s._lock()
        with pytest.raises(a.LockedError):
            s.set_fov(1.0)
        s._unlock()
        v = s._version
        s.set_fov(s.fov)
        assert s._version == v + 1
        with pytest.raises(TypeError):
            s.add_light(object())


@pytest.mark.parametrize("d", [3, 5])
def test_pickles_stay_inside_the_port(d):
    """A port object unpickles to a port object (the JAX package's pickles
    name the ``ntracer`` alias instead)."""
    nt = ntracer_tpu_torch.NTracer(d)
    mat = ntracer_tpu_torch.Material((0.2, 0.4, 0.6), opacity=0.5)
    pts = [nt.Vector.axis(i) for i in range(d)]
    objs = [nt.Vector(*range(d)), nt.Matrix.identity(), mat,
            ntracer_tpu_torch.Color(1, 0.5, 0), nt.AABB(),
            nt.TrianglePrototype(pts, mat).primitive]
    for obj in objs:
        data = pickle.dumps(obj)
        assert b"ntracer_tpu_torch" in data and b"ntracer.render" not in data
        back = pickle.loads(data)
        assert type(back) is type(obj)
        assert type(back).__module__.startswith("ntracer_tpu_torch")
        assert pickle.dumps(back) == data


def test_strip_rendering_names_its_item():
    scene = random_scene(3, n=10, seed=1)
    with pytest.raises(NotImplementedError, match=r"item 11\)"):
        scene._render_strip(None, 0, 1)
    with pytest.raises(NotImplementedError, match=r"item 11\)"):
        ntracer_tpu_torch.NTracer(3).BoxScene()._render_strip(None, 0, 1)
