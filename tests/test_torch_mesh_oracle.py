"""The oracle of chip_smoke.py's glass mesh path: a sphere's glass needs no
unbatched build."""

import contextlib

import numpy as np

from ntracer_tpu_torch import NTracer, Material, kdnodes, kdtree
from ntracer_tpu_torch.engine import wavefront as pwf

import chip_smoke


def test_glass_sphere_oracle_needs_no_unbatched_build(monkeypatch):
    """The oracle records one transparent hit per triangle batch per leaf,
    so a transparent scene is usually held to the oracle of an unbatched
    build.  A ray meets a sphere's surface at two far apart points, and no
    batch holds two of its glass hits: the batched build's oracle gives the
    unbatched one's colors.  So chip_smoke.py asks the batched glass mesh
    (the unbatched 500k-triangle sphere costs 72-86 s an oracle pixel)."""
    monkeypatch.setattr(kdnodes, "OCCLUDES_EARLY_OUT", False)
    nt = NTracer(3)
    tris = chip_smoke.sphere_mesh(8000)
    solid, glass = Material((0.3, 0.8, 0.5)), \
        Material((1, 0.7, 0.7), opacity=0.4)
    mix = [glass if i % 2 else solid for i in range(len(tris))]
    scenes = []
    for flat in (False, True):
        with (chip_smoke.unbatched(kdtree) if flat else
              contextlib.nullcontext()):
            scene, _cam = chip_smoke.mesh_scene(
                nt, nt.TrianglePrototype.batch_from_points(tris, mix))
        chip_smoke.turn(nt, scene, nt.Camera(), chip_smoke.MESH_DISTANCE,
                        chip_smoke.OBLIQUE)
        scene._set_view_size(32, 32)
        scenes.append(scene)
    # pixels seen through glass (the engine's mask), and any pixels
    _colors, masks = pwf.frame_colors(scenes[0], 32, 32, "cpu", masks=True)
    layered = np.flatnonzero(masks["layered"])
    assert len(layered) > 100
    rng = np.random.RandomState(0)
    for p in np.concatenate([rng.choice(layered, 32, replace=False),
                             rng.choice(32 * 32, 16, replace=False)]):
        y, x = divmod(int(p), 32)
        a, b = (sc._pixel_color(x, y) for sc in scenes)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
