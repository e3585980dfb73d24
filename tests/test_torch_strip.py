"""Strips: ``_render_strip`` of the port's scenes against the JAX package's
``render_strip_composite`` / ``render_strip_box`` -- rows from y0 != 0 of a
frame whose width is no multiple of 32, in linear pixel order, batches of
TILE rays padded by pixel (0, 0)."""

import numpy as np
import pytest

from ntracer_tpu.engine import wavefront as jwf

from _torch_helpers import (JAX, PORT, api, random_scene, jax_device_scene,
                            two_lights)

W, H = 40, 30
Y0, ROWS = 7, 9


def _fmt(pkg):
    a = api(pkg)
    return a.ImageFormat(W, H, [a.Channel(8, 1, 0, 0), a.Channel(8, 0, 1, 0),
                                a.Channel(8, 0, 0, 1)])


def _lit(d, pkg, specular=1.0):
    a = api(pkg)
    scene = random_scene(d, n=300, seed=11, spread=0.8, pkg=pkg,
                         material=a.Material((1, 0.5, 0.5),
                                             specular_intensity=specular))
    two_lights(scene, a.NTracer(d))
    scene.set_shadows(True)
    return scene


@pytest.mark.parametrize("d", [3, 4])
def test_composite_strip_matches_jax(d, monkeypatch):
    """A lit composite scene with shadows: the port's strip equals JAX's to
    rtol 2e-6 / atol 2e-7 (XLA contracts a*b+c on the CPU).  The surfaces
    are matte: a highlight raises the color to the 8th power, which makes
    XLA's ulps eight times larger, past that tolerance, on whole frames as
    on strips (5 pixels of the shiny d = 3 scene's 40x30 frame); the next
    test holds the shiny strips to the port's frames."""
    jscene, pscene = _lit(d, JAX, 0.0), _lit(d, PORT, 0.0)
    jax_device_scene(jscene, monkeypatch)
    ref = jwf.render_strip_composite(jscene, _fmt(JAX), Y0, ROWS)
    got = pscene._render_strip(_fmt(PORT), Y0, ROWS, device="cpu")
    assert got.shape == (ROWS, W, 3) and got.dtype == np.float32
    assert (got.max(axis=2) > 0.05).sum() > 40
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)


@pytest.mark.parametrize("d", [3, 4])
def test_composite_strip_equals_frame_rows(d):
    """The strip of a shiny lit scene equals the same rows of the port's
    whole frame bit for bit: a ray's color does not depend on the block it
    is traced in."""
    from ntracer_tpu_torch.engine import wavefront as pwf
    scene = _lit(d, PORT)
    got = scene._render_strip(_fmt(PORT), Y0, ROWS, device="cpu")
    frame = pwf.frame_colors(scene, W, H, "cpu")
    assert np.array_equal(got, frame[Y0:Y0 + ROWS])
    assert (frame.max(axis=2) > 0.05).sum() > 100


def test_box_strip_matches_jax():
    """A turned 5-D BoxScene: the strip equals JAX's to rtol 2e-6 / atol
    2e-7, on a strip of more than TILE rays (two batches, the second
    padded)."""
    fmt_w, rows = 200, 170          # 34,000 pixels
    scenes = []
    for pkg in (JAX, PORT):
        nt = api(pkg).NTracer(5)
        scene = nt.BoxScene()
        cam = nt.Camera()
        cam.translate(nt.Vector.axis(2, -3))
        cam.transform(nt.Matrix.rotation(cam.axes[2], cam.axes[0], 0.4))
        scene.set_camera(cam)
        scenes.append(scene)
    jfmt = api(JAX).ImageFormat(fmt_w, 300, [api(JAX).Channel(8, 1, 0, 0)])
    pfmt = api(PORT).ImageFormat(fmt_w, 300, [api(PORT).Channel(8, 1, 0, 0)])
    ref = jwf.render_strip_box(scenes[0], jfmt, 11, rows)
    got = scenes[1]._render_strip(pfmt, 11, rows, device="cpu")
    assert got.shape == (rows, fmt_w, 3) and rows * fmt_w > jwf.TILE
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)
