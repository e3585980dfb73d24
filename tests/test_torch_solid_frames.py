"""Frames of solids through ntracer_tpu_torch's ``BlockingRenderer`` on the
CPU against the JAX package and the scalar oracle: solids alone (a pool of
padding only) and a glass cube with a glass triangle.

Tolerances as tests/test_torch_solids.py states them: against JAX rtol
2e-6, atol 2e-7, except pixels whose ray meets a sphere (1e-4: the JAX
frame's FMA in the sphere's discriminant), bytes within one code; against
the oracle 5e-5, 5e-4 on composed pixels.
"""

import numpy as np
import jax.numpy as jnp

from ntracer_tpu.engine import packing as jpack
from ntracer_tpu_torch import BlockingRenderer, kdnodes
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import JAX, PORT, api, rgb8, solids_only_scene, _smoke
from test_torch_frame import _jax_frame_colors
from test_torch_solids import _sphere_pixels

N = 64


def _renders_as_jax(pscene, jscene):
    """The port's frame through its renderer and ``frame_colors`` against
    the JAX package's: (colors, masks)."""
    fmt = rgb8(N, N)
    buf = bytearray(fmt.pitch * N)
    assert BlockingRenderer(device="cpu").render(buf, fmt, pscene)
    assert not pscene.locked
    ref = _jax_frame_colors(jscene, N, N)
    got, masks = pwf.frame_colors(pscene, N, N, "cpu", masks=True)
    sphere = _sphere_pixels(pscene, N)
    close = np.isclose(got, ref, rtol=2e-6, atol=2e-7).all(axis=2)
    assert close[~sphere].all()
    assert np.abs(got - ref)[sphere].max(initial=0) <= 1e-4
    ref_bytes = np.asarray(jpack.pack_device(
        jnp.asarray(ref.reshape(-1, 3)), jpack.format_key(fmt)))
    diff = np.abs(np.frombuffer(bytes(buf), np.uint8).astype(int)
                  - ref_bytes.reshape(-1).astype(int))
    assert diff.max() <= 1
    return got, masks


def test_solids_only_frame_matches_jax_and_oracle(monkeypatch):
    """No triangle at all: the pool is one chunk of padding that every ray
    misses, and the solids decide -- a glass cube before an opaque sphere,
    a global light with shadows that the cube filters."""
    scene = solids_only_scene(glass=True)
    cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    assert cfg.n_solids == 2 and cfg.has_transparency
    assert int(arrs["res_ids"][0, 0, 0]) == 0 and arrs["res_neff"] == 1
    colors, masks = _renders_as_jax(scene, solids_only_scene(pkg=JAX,
                                                             glass=True))
    assert masks["hit"].sum() > 100 and masks["layered"].sum() > 50
    assert masks["filtered"].sum() > 5
    monkeypatch.setattr(kdnodes, "OCCLUDES_EARLY_OUT", False)
    scene._set_view_size(N, N)
    rng = np.random.RandomState(3)
    pixels = []
    for name, k in (("layered", 16), ("filtered", 16), ("hit", 8)):
        ys_, xs_ = np.nonzero(masks[name])
        pixels += [(int(xs_[i]), int(ys_[i]))
                   for i in rng.choice(len(xs_), k)]
    pixels += [(int(rng.randint(N)), int(rng.randint(N))) for _ in range(8)]
    for x, y in pixels:
        tol = 5e-4 if masks["layered"][y, x] else 5e-5
        diff = float(np.abs(scene._pixel_color(x, y) - colors[y, x]).max())
        assert diff < tol, (x, y, diff)


def _glass_cube(pkg):
    """A glass triangle before a glass cube behind it (tests/
    test_torch_glass.py's scene) under a point light with shadows."""
    a = api(pkg)
    nt = a.NTracer(3)
    glass = a.Material((1, 1, 1), opacity=0.5)
    protos = [nt.TrianglePrototype([nt.Vector(0, 0, 0), nt.Vector(1, 0, 0),
                                    nt.Vector(0, 1, 0)], glass),
              nt.SolidPrototype(_smoke().CUBE, nt.Vector(0, 0, 2),
                                nt.Matrix.identity(),
                                a.Material((0.4, 0.9, 0.6), opacity=0.5))]
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, -8))
    scene.set_camera(cam)
    scene.add_light(nt.PointLight(nt.Vector(0, 4, -4), (1, 0.8, 0.6)))
    scene.set_shadows(True)
    return scene


def test_glass_cube_frame_matches_jax():
    """A glass cube in the K slots behind a glass triangle: no sphere, so
    every pixel at rtol 2e-6."""
    pscene = _glass_cube(PORT)
    _colors, masks = _renders_as_jax(pscene, _glass_cube(JAX))
    assert not _sphere_pixels(pscene, N).any()
    assert masks["layered"].sum() > 100
