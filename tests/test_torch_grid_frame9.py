"""Frames of 9-D scenes (the grid walks, kernels 2.9 and 2.10) through
ntracer_tpu_torch vs the JAX package and the scalar oracle.

The JAX package renders a scene of more than 8 dimensions with its Pallas
grid kernels (here in interpret mode, under NTRACER_FORCE_KERNELS) and its
row pipeline; the port keeps its transposed pipeline.  The package states
that the two layouts give the same values: colors must agree to rtol 2e-6 /
atol 2e-7 (XLA on the CPU contracts a*b+c into FMAs, the port rounds every
operation), bytes within one code, and 64 pixels the oracle's to 5e-5.

The scenes are the 9-orthoplex seen from a turned camera (the axis view of
a regular polytope is a mirror hyperplane), lit with shadows on, with a
companion (``_torch_helpers.orthoplex_scene``): a smaller orthoplex beside
it that casts a shadow on it, or, with every surface a mirror and
reflection depth 2, a large simplex under it as a floor, so that the bounce
rays (which take the grid walk without shared rows) meet surfaces.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from ntracer_tpu.engine import packing as jpack
from ntracer_tpu_torch import BlockingRenderer, kdnodes
from ntracer_tpu_torch.engine import grid_kernels as gk
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import JAX, PORT, orthoplex_scene, rgb8, jax_device_scene
from test_torch_frame import _jax_frame_colors

W = H = 64
D = 9


def check_frame(d, companion, monkeypatch):
    """One scene of dimension ``d`` through both packages (see the module's
    docstring)."""
    reflectivity = 0.5 if companion == "floor" else 0.0
    jscene = orthoplex_scene(d, pkg=JAX, reflectivity=reflectivity,
                             companion=companion)
    pscene = orthoplex_scene(d, pkg=PORT, reflectivity=reflectivity,
                             companion=companion)
    jcfg, _arrs, _ = jax_device_scene(jscene, monkeypatch)
    pcfg, parrs, _ = pwf.get_device_scene(pscene, "cpu")
    assert pcfg == pwf.SceneConfig(**{k: v for k, v in vars(jcfg).items()
                                      if k != "prim_axis"})
    assert pcfg.d == d and pcfg.shadows and "kern_gt" in parrs
    assert pcfg.has_reflectivity == bool(reflectivity)

    ref = _jax_frame_colors(jscene, W, H)
    calls = []
    inner_near, inner_occ = gk.nearest_hit, gk.occluded

    def nearest_hit(kern, oT, dT, skip, d_, sh=None):
        out = inner_near(kern, oT, dT, skip, d_, sh=sh)
        calls.append(("nearest", sh is not None, int((out[1] >= 0).sum())))
        return out

    def occluded(kern, oT, dT, ldist, skip, d_):
        out = inner_occ(kern, oT, dT, ldist, skip, d_)
        calls.append(("occluded", int((ldist > 0).sum()), int(out[0].sum())))
        return out

    monkeypatch.setattr(gk, "nearest_hit", nearest_hit)
    monkeypatch.setattr(gk, "occluded", occluded)
    got, masks = pwf.frame_colors(pscene, W, H, "cpu", masks=True)
    monkeypatch.undo()

    # the walks the frame took: one shared-row trace, then a per-ray trace
    # a bounce; two shadow queries each, some of them blocked
    bounces = 2 if reflectivity else 0
    traces = [c for c in calls if c[0] == "nearest"]
    assert [c[1] for c in traces] == [True] + [False] * bounces
    assert len(calls) == 3 * (bounces + 1)
    assert masks["hit"].sum() > 400
    if bounces:
        assert traces[1][2] > 100 and traces[2][2] > 0, \
            "the reflections meet no surface"
    else:
        assert sum(c[2] for c in calls if c[0] == "occluded") > 0
        assert (masks["shadowed"] & ~masks["grazing"]).sum() >= 10

    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)

    # packed bytes through the port's renderer: within one code of JAX's
    fmt = rgb8(W, H)
    buf = bytearray(fmt.pitch * H)
    assert BlockingRenderer(device="cpu").render(buf, fmt, pscene)
    ref_bytes = np.asarray(jpack.pack_device(
        jnp.asarray(ref.reshape(-1, 3)), jpack.format_key(fmt)))
    diff = np.abs(np.frombuffer(bytes(buf), np.uint8).astype(int)
                  - ref_bytes.reshape(-1).astype(int))
    assert diff.max() <= 1

    # the oracle at seeded pixels: shadowed ones, others on the bodies, any
    # (with exact occlusion: the reference's early-out misses occluders of
    # global lights, the engine is any-hit)
    monkeypatch.setattr(kdnodes, "OCCLUDES_EARLY_OUT", False)
    pscene._set_view_size(W, H)
    rng = np.random.RandomState(1)
    pixels = []
    for mask, n in ((masks["shadowed"], 0 if bounces else 16),
                    (masks["hit"], 48 if bounces else 32),
                    (np.ones((H, W), bool), 16)):
        ys, xs = np.nonzero(mask)
        pixels += [(int(xs[i]), int(ys[i])) for i in rng.choice(len(xs), n)]
    worst = max(float(np.abs(pscene._pixel_color(x, y) - got[y, x]).max())
                for x, y in pixels)
    assert worst < 5e-5, f"worst port-vs-oracle diff {worst}"


@pytest.mark.parametrize("companion", ["shade", "floor"])
def test_frame_matches_jax_and_oracle(companion, monkeypatch):
    check_frame(D, companion, monkeypatch)
