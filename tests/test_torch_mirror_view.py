"""The 120-cell seen along an axis: why its frames are held to the scalar
oracle from a turned camera (chip_smoke.py's ``OBLIQUE``).

The camera of bench.py's flagship sits on axis 2 and sees the 3-space
x3 = 0, a mirror hyperplane of the polytope.  Whole 2-faces of the boundary
lie in it, each shared by two simplices that mirror each other, so a ray of
that view meets both exactly on their common boundary; so do the shadow rays
along the global light, which stay in the hyperplane.  Which of the two
counts as hit is then a matter of the last bit, and engine and oracle, who
round differently, may tell apart what the point light (off the hyperplane)
and the alternating materials make visibly different.

Shown here on the lit and the glass 120-cell at 64x64.  A pixel is on a
boundary ray when its primary ray or one of its shadow rays passes a simplex
within 1e-5 (barycentric) of its boundary, found in float64 from the
scene's vertices, or when a light grazes its surface.  Every pixel on which
the oracle differs from the port is one; off them the port equals the JAX
package as it does from any other view (on them the two engines, which
differ only in rounding, part on a few rays themselves); and from the turned
camera hardly a ray passes a boundary.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntracer_tpu.engine import wavefront as jwf
from ntracer_tpu_torch import kdnodes
from ntracer_tpu_torch.engine import wavefront as pwf

import chip_smoke
from _torch_helpers import JAX, PORT, polytope_scene, unbatched, \
    jax_device_scene
from test_torch_glass import MAX_FLIPS, W, H, _flips, _record, _t

BOUNDARY_TOL = 1e-5


def _scene(glass, angle, pkg):
    with unbatched(pkg):
        scene = polytope_scene((5, 3, 3), angle=angle, glass=glass, lit=True,
                               pkg=pkg)
    scene.set_fov(0.8)
    return scene


def boundary_rays(P, o, dv, tmax, tol=BOUNDARY_TOL, step=256):
    """Which rays (``o``, ``dv`` (R, k) float64, reaching to ``tmax`` (R,),
    0 = no ray) pass a simplex of ``P`` (N, k, k) within ``tol`` of its
    boundary, in barycentric coordinates: (R,) bool."""
    p0 = P[:, 0]
    E = P[:, 1:] - p0[:, None]
    nrm = np.linalg.svd(E)[2][:, -1]
    G = np.linalg.solve(E @ E.transpose(0, 2, 1), E)
    c = (p0 * nrm).sum(1)
    out = np.zeros(len(o), bool)
    act = np.nonzero(tmax > 0)[0]
    for i in range(0, len(act), step):
        r = act[i:i + step]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (c[None] - o[r] @ nrm.T) / (dv[r] @ nrm.T)
            X = o[r][:, None] + t[..., None] * dv[r][:, None] - p0[None]
            b = np.einsum("nik,rnk->rni", G, X)
            mb = np.minimum(1 - b.sum(2), b.min(2))
            edge = (np.abs(mb) <= tol) & (t > 0) \
                & (t < tmax[r][:, None] * (1 + tol))
        out[r] = edge.any(1)
    return out


def _rays(scene):
    scene._set_view_size(W, H)
    fov = pwf._fov_params(W, H, scene.fov)
    groups = pwf._frame_groups(-(-(W * H) // pwf.TILE))
    xs, ys, unswz = pwf._frame_coords(groups, W, "cpu")
    oT, dT = pwf.make_rays(
        _t(np.asarray(scene._cam._origin, np.float32)),
        _t(np.asarray(scene._cam._t, np.float32)), *fov, xs[:W * H],
        ys[:W * H])
    return oT, dT, unswz


def _f64(x):
    return x.numpy().T.astype(np.float64)


@pytest.mark.parametrize("glass", [False, True], ids=["lit", "glass"])
def test_axis_view_differs_from_the_oracle_only_on_boundary_rays(
        glass, monkeypatch):
    P = chip_smoke.hull_simplices(
        chip_smoke.polytope_vertices([5, 3, 3])).astype(np.float64)
    jscene, pscene = _scene(glass, 0.0, JAX), _scene(glass, 0.0, PORT)
    jcfg, arrs, _ = jax_device_scene(jscene, monkeypatch)
    jdev = jwf.get_device_scene(jscene)[1]
    pcfg, tens, _ = pwf.get_device_scene(pscene, "cpu")
    assert pcfg.has_transparency == glass and pcfg.shadows
    oT, dT, unswz = _rays(pscene)
    R = oT.shape[1]

    # both engines, every shadow query logged
    jlog, plog, rays = [], [], []
    _record(monkeypatch, jwf, jlog, np.asarray)
    _record(monkeypatch, pwf, plog, lambda x: x.numpy())
    recorded = pwf.occlusion

    def with_rays(arrs_, cfg, o, dirs, ldist, skip, **kw):
        rays.append((_f64(o), _f64(dirs), ldist.numpy().astype(np.float64)))
        return recorded(arrs_, cfg, o, dirs, ldist, skip, **kw)

    monkeypatch.setattr(pwf, "occlusion", with_rays)
    masks = {}
    got = pwf._ray_colors_T(tens, pcfg, pwf._scene_dyn(pscene, "cpu"), oT, dT,
                            masks=masks).numpy()
    cam_o = jnp.asarray(np.asarray(pscene._cam._origin, np.float32))
    ref = np.asarray(jwf._ray_colors_T(
        jdev, jcfg, jwf._scene_dyn(jscene), jnp.asarray(oT.numpy().T),
        jnp.asarray(dT.numpy().T), False,
        jwf.primary_ctx(jdev, jcfg, cam_o), want_T=True))
    monkeypatch.undo()

    # rays that pass a simplex at its boundary: primary and shadow rays
    primary = boundary_rays(P, _f64(oT), _f64(dT), np.full(R, np.inf))
    degenerate = primary | masks["grazing"].numpy()
    for o, dirs, ldist in rays:
        degenerate |= boundary_rays(P, o, dirs, np.minimum(ldist, 1e30))
    body = (masks["hit"] | masks.get("layered", masks["hit"])).numpy()
    assert primary[body].mean() > 0.2

    # off those rays the port is the JAX package, as from any other view;
    # on them even the two engines, one algorithm under two roundings
    # (XLA contracts multiply-adds on the CPU), part on some
    flips = _flips(jlog, plog) | ~np.isclose(got, ref, rtol=2e-6,
                                             atol=2e-7).all(axis=0)
    print(f"{int(flips.sum())} of {R} rays differ between the engines, "
          f"{int((flips & ~degenerate).sum())} of them off the boundary "
          f"rays")
    assert (flips & ~degenerate).sum() <= MAX_FLIPS
    assert flips.sum() <= 0.02 * R

    # the oracle on every pixel of the body
    monkeypatch.setattr(kdnodes, "OCCLUDES_EARLY_OUT", False)
    pscene._set_view_size(W, H)
    frame = pwf.frame_colors(pscene, W, H, "cpu")
    pad = (0, pwf.TILE - R)
    to_px = lambda v: unswz(_t(np.pad(v, pad))).numpy()[:R].reshape(H, W)
    body_px, degenerate_px = to_px(body), to_px(degenerate)
    tol = 5e-4 if glass else 5e-5
    bad = np.zeros((H, W), bool)
    for y, x in zip(*np.nonzero(body_px)):
        bad[y, x] = np.abs(pscene._pixel_color(int(x), int(y))
                           - frame[y, x]).max() > tol
    print(f"{int(body_px.sum())} pixels of the body, "
          f"{int((degenerate_px & body_px).sum())} on boundary rays, "
          f"{int(bad.sum())} differ from the oracle, "
          f"{int((bad & ~degenerate_px).sum())} of them elsewhere")
    assert bad.sum() > 0
    assert not (bad & ~degenerate_px).any()

    # from the turned camera hardly a primary ray passes a boundary
    oT, dT, _ = _rays(_scene(glass, chip_smoke.OBLIQUE, PORT))
    turned = boundary_rays(P, _f64(oT), _f64(dT), np.full(R, np.inf))
    print(f"turned camera: {int(turned.sum())} of {R} rays on a boundary")
    assert turned.mean() < 0.002
