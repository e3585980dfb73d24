"""The repository's apps on the port: ``pygame_render`` against the JAX
package's, and scripts/polytope.py and scripts/hypercube.py run unmodified
through ``python -m ntracer_tpu_torch.alias``."""

import os
import subprocess
import sys
import textwrap

import pytest

from ntracer_tpu_torch import BlockingRenderer
from ntracer_tpu_torch import pygame_render as ppr

from _torch_helpers import REPO, random_scene

ENV = dict(os.environ, SDL_VIDEODRIVER="dummy")
ENV.pop("NTRACER_PLATFORM", None)


def _launch(*args, timeout=600):
    return subprocess.run(
        [sys.executable, "-m", "ntracer_tpu_torch.alias", "--device", "cpu",
         *args], capture_output=True, text=True, timeout=timeout, env=ENV,
        cwd=REPO)


@pytest.fixture
def pygame(monkeypatch):
    pg = pytest.importorskip("pygame")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    pg.display.init()
    yield pg
    pg.display.quit()


def _key(channels):
    return [(c.bit_size, c.f_r, c.f_g, c.f_b, c.f_c, c.tfloat)
            for c in channels]


@pytest.mark.parametrize("depth", [8, 16, 24, 32])
def test_channels_from_surface_match_jax(pygame, depth):
    from ntracer_tpu import pygame_render as jpr
    surface = pygame.Surface((8, 8), depth=depth)
    got = ppr.channels_from_surface(surface)
    assert _key(got) == _key(jpr.channels_from_surface(surface))
    assert sum(c.bit_size for c in got) == surface.get_bytesize() * 8


def test_pygame_renderer_fills_surface_and_posts_on_complete(pygame):
    """PygameRenderer(device="cpu") renders into the surface's pixels (the
    blocking renderer's bytes for the surface's format) and posts
    ON_COMPLETE with the renderer and the surface."""
    scene = random_scene(3, n=40, seed=7)
    surface = pygame.Surface((24, 24), depth=32)
    renderer = ppr.PygameRenderer(device="cpu")
    renderer.begin_render(surface, scene)
    event = pygame.event.wait(120_000)
    while event.type not in (ppr.ON_COMPLETE, pygame.NOEVENT):
        event = pygame.event.wait(120_000)
    assert event.type == ppr.ON_COMPLETE
    assert event.renderer is renderer and event.surface is surface
    fmt = ppr.ImageFormat(24, 24, ppr.channels_from_surface(surface),
                          surface.get_pitch())
    expect = bytearray(fmt.pitch * 24)
    assert BlockingRenderer(device="cpu").render(expect, fmt, scene)
    assert surface.get_buffer().raw == bytes(expect) and any(expect)
    renderer.abort_render()


def test_polytope_benchmark_on_the_port():
    """polytope.py --benchmark drives the port's CallbackRenderer with
    several frames in flight."""
    r = _launch("scripts/polytope.py", "4", "3", "--benchmark", "-s",
                "48x48", "-f", "5")
    assert r.returncode == 0, r.stderr[-500:]
    assert "rendered 5 frame(s)" in r.stdout
    assert "frames per second" in r.stdout


def test_hypercube_benchmark_on_the_port():
    r = _launch("scripts/hypercube.py", "-d", "4", "--benchmark", "-s",
                "48x48", "-f2", "3")
    assert r.returncode == 0, r.stderr[-500:]
    assert "rendered 3 frame(s)" in r.stdout


def test_launcher_imports_neither_jax_nor_the_jax_package(tmp_path):
    """A script run through the launcher sees the port under the names
    ``ntracer`` and ``ntracer_tpu.primitives``, renders a 4-D polytope
    scene through them on the launcher's device, and neither jax nor the
    real JAX package is ever imported."""
    script = tmp_path / "probe.py"
    script.write_text(textwrap.dedent("""\
        import pickle, sys
        import ntracer, ntracer.tracer4, ntracer.render
        from ntracer import NTracer, Material, ImageFormat, Channel
        from ntracer import BlockingRenderer, CallbackRenderer
        from ntracer.pygame_render import channels_from_surface
        from ntracer_tpu.primitives import TrianglePrototype
        import ntracer_tpu_torch
        nt = NTracer(4)
        assert ntracer.tracer4.__name__ == "ntracer_tpu_torch.tracer4"
        pts = [nt.Vector.axis(i) for i in range(4)]
        scene = nt.build_composite_scene(
            [TrianglePrototype(pts, Material((1, 0.5, 0.5)))])
        cam = nt.Camera()
        cam.translate(nt.Vector.axis(2, -4))
        scene.set_camera(cam)
        fmt = ImageFormat(8, 8, [Channel(8, 1, 0, 0)])
        r = BlockingRenderer()
        assert str(r.device) == "cpu", r.device
        cr = CallbackRenderer()
        assert isinstance(cr, ntracer_tpu_torch.CallbackRenderer)
        assert r.render(bytearray(64), fmt, scene)
        c = pickle.loads(pickle.dumps(ntracer.render.Color(1, 0, 0)))
        assert type(c) is ntracer_tpu_torch.Color
        assert not hasattr(sys.modules["ntracer_tpu"], "__file__")
        bad = [m for m in sys.modules if m.split(".")[0] == "jax"
               or (m.startswith("ntracer_tpu.")
                   and m != "ntracer_tpu.primitives")]
        assert not bad, bad
        assert sys.modules["ntracer_tpu.primitives"].__name__ == \\
            "ntracer_tpu_torch.primitives"
        print("ok", sys.argv[1:])
        """))
    r = _launch(str(script), "a", "--b")
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout.strip().endswith("ok ['a', '--b']")
