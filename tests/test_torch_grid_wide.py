"""The grid walks past d = 16 (kernels 2.9 and 2.10 on their wide bodies on
the card) vs the JAX package's Pallas grid kernels, which take any d.

On the CPU the port's wrappers take their twins, which take any d; the
card's wide bodies are held to the same twins bit for bit by
tests/test_torch_gpu.py and chip_smoke.py.  Here the JAX kernels run in
interpret mode (as tests/test_torch_grid.py runs them) on pools built
straight from random simplices (``chip_smoke.simplex_pool``'s rows: a
scene's k-d build takes minutes at these d), and one 17-D scene renders
through both packages' renderers: the regular 17-simplex among 40 random
simplices (``chip_smoke.wide_scene``), lit, shadows on.  Tolerances as in
tests/test_torch_grid.py and tests/test_torch_grid_frame9.py: ids and
``blocked`` exact, t within rtol 1e-6 plus its numerator's rounding bound
(XLA on the CPU contracts a*b+c into FMAs, the twin rounds every
operation), colors at rtol 2e-6 / atol 2e-7, bytes within one code, the
oracle's pixels at 5e-5.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntracer_tpu.engine import packing as jpack
from ntracer_tpu.engine import pallas_kernels as jpk
from ntracer_tpu_torch import BlockingRenderer, kdnodes
from ntracer_tpu_torch.engine import grid_kernels as gk
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import JAX, PORT, api, rgb8, jax_device_scene, _smoke
from test_torch_frame import _jax_frame_colors
from test_torch_grid import _t_rounding_bound

N = 4096              # 8 walk blocks
W = H = 32


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module", params=[17, 20])
def pool(request):
    """A pool of 600 random simplices of dimension d (two tiles) in the
    layouts of both packages, and rays from the camera at -8 on axis 2
    aimed at seeded points inside seeded simplices; half of them skip the
    pool id they hit first."""
    d = request.param
    smoke = _smoke()
    pts = smoke.random_simplices(600, d)
    rows = smoke.simplex_rows(pts)
    T = 2 * gk.TRI_BLOCK
    padded = [np.concatenate([rows[k], np.zeros((T - len(pts),)
                                                + rows[k].shape[1:],
                                                np.float32)])
              for k in ("p1", "fn", "en", "dc", "lo", "hi")]
    kern = gk.prepare_tri_arrays(*padded, d)
    ref = jpk.prepare_tri_arrays(*padded, d)
    for k in ref:
        assert np.array_equal(kern[k], ref[k]), k
    origin = np.zeros(d, np.float32)
    origin[2] = -8.0
    dirs = smoke.aimed(origin, pts, N).T.copy()          # (N, d)
    o = np.broadcast_to(origin, (N, d)).copy()
    jk = {k: jnp.asarray(v) for k, v in kern.items()}
    _t0, first = jpk.nearest_hit(jk, jnp.asarray(o), jnp.asarray(dirs),
                                 jnp.full((N,), -1, jnp.int32), d)
    first = np.asarray(first)
    skip = np.where(np.arange(N) % 2 == 0, first, -1).astype(np.int32)
    return dict(d=d, kern=kern, jk=jk, pk={k: _t(v) for k, v in kern.items()},
                origin=origin, o=o, dirs=dirs, first=first, skip=skip)


@pytest.mark.parametrize("mode", ["shared", "own origins"])
def test_wide_nearest_hit_ref_matches_pallas(pool, mode):
    """Kernel 2.9's twin at d = 17 and 20 against the JAX kernel: the
    shared-origin test (the shared rows) and the per-ray one, every other
    ray skipping its first hit."""
    d = pool["d"]
    o, dirs, skip = pool["o"], pool["dirs"], pool["skip"]
    jsh = psh = None
    if mode == "shared":
        jsh = jpk.shared_rows(pool["jk"]["gt"], pool["jk"]["ci"],
                              jnp.asarray(pool["origin"]), d)
        psh = gk.shared_rows(pool["pk"]["gt"], pool["pk"]["ci"],
                             _t(pool["origin"]), d)
        assert np.array_equal(psh.numpy(), np.asarray(jsh))
    jt, jid = jpk.nearest_hit(pool["jk"], jnp.asarray(o), jnp.asarray(dirs),
                              jnp.asarray(skip), d, sh=jsh)
    jt, jid = np.asarray(jt), np.asarray(jid)
    pt, pid, tiles = gk.nearest_hit(pool["pk"], _t(o.T), _t(dirs.T),
                                    _t(skip), d, sh=psh)
    pt, pid = pt.numpy(), pid.numpy()
    hits = jid >= 0
    assert np.array_equal(pid, jid)
    # every ray hits the simplex it is aimed at, unless it skips it
    skips = skip >= 0
    assert hits[~skips].all() and skips.sum() > N // 4
    assert (jid[skips] != skip[skips]).all()
    bound = _t_rounding_bound(o, dirs, jid, {"kern_gt": pool["kern"]["gt"],
                                             "kern_ci": pool["kern"]["ci"]},
                              d)
    with np.errstate(invalid="ignore"):
        assert (np.abs(pt - jt) <= 1e-6 * np.abs(jt) + bound)[hits].all()
    assert np.array_equal(pt[~hits], jt[~hits])
    assert tiles.shape == (N // 512,) and int(tiles.max()) == 2


def test_wide_occluded_ref_matches_pallas(pool):
    """Kernel 2.10's twin at d = 17 and 20 against the JAX kernel: the
    aimed rays again, to a little past their first hit on even rays
    (blocked) and to a little before it on odd rays (the engines' t differ
    by rounding: no ldist within it), and a dead block."""
    d = pool["d"]
    o, dirs = pool["o"], pool["dirs"]
    none = np.full((N,), -1, np.int32)
    jt, jid = jpk.nearest_hit(pool["jk"], jnp.asarray(o), jnp.asarray(dirs),
                              jnp.asarray(none), d)
    jt, jid = np.asarray(jt), np.asarray(jid)
    hit = jid >= 0
    even = np.arange(N) % 2 == 0
    ldist = np.where(hit, jt * np.where(even, 1.001, 0.999), 0)
    ldist = ldist.astype(np.float32)
    ldist[-512:] = 0
    ref = np.asarray(jpk.occluded(pool["jk"], jnp.asarray(o),
                                  jnp.asarray(dirs), jnp.asarray(ldist),
                                  jnp.asarray(none), d))
    got, tiles = gk.occluded(pool["pk"], _t(o.T), _t(dirs.T), _t(ldist),
                             _t(none), d)
    assert np.array_equal(got.numpy(), ref)
    assert ref[even & (ldist > 0)].all() and not ref[~even].any()
    assert int(tiles[-1]) == 0


def test_wide_frame_matches_jax_and_oracle(monkeypatch):
    """A 32x32 frame of the regular 17-simplex among 40 random simplices
    (``chip_smoke.wide_scene``, camera turned off the axis view, two
    lights, shadows on) through the port's renderer against the JAX
    package's frame and the scalar oracle: one 2.9 and two 2.10 walks."""
    d = 17
    smoke = _smoke()
    ja, pa = api(JAX), api(PORT)
    jscene = smoke.wide_scene(ja.NTracer(d), ja.Material((1, 0.5, 0.5)),
                              n=40)[0]
    pscene, _cam, n = smoke.wide_scene(pa.NTracer(d),
                                       pa.Material((1, 0.5, 0.5)), n=40)
    assert n == d + 1 + 40
    jcfg, _arrs, _ = jax_device_scene(jscene, monkeypatch)
    pcfg, parrs, _ = pwf.get_device_scene(pscene, "cpu")
    assert pcfg == pwf.SceneConfig(**{k: v for k, v in vars(jcfg).items()
                                      if k != "prim_axis"})
    assert pcfg.d == d and pcfg.shadows and "kern_gt" in parrs
    ref = _jax_frame_colors(jscene, W, H)

    calls = []
    inner_near, inner_occ = gk.nearest_hit, gk.occluded

    def nearest_hit(kern, oT, dT, skip, d_, sh=None):
        calls.append(("nearest", d_, sh is not None))
        return inner_near(kern, oT, dT, skip, d_, sh=sh)

    def occluded(kern, oT, dT, ldist, skip, d_):
        calls.append(("occluded", d_))
        return inner_occ(kern, oT, dT, ldist, skip, d_)

    monkeypatch.setattr(gk, "nearest_hit", nearest_hit)
    monkeypatch.setattr(gk, "occluded", occluded)
    got, masks = pwf.frame_colors(pscene, W, H, "cpu", masks=True)
    monkeypatch.setattr(gk, "nearest_hit", inner_near)
    monkeypatch.setattr(gk, "occluded", inner_occ)
    assert calls == [("nearest", d, True), ("occluded", d),
                     ("occluded", d)]
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    assert masks["hit"].sum() > 0
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)

    fmt = rgb8(W, H)
    buf = bytearray(fmt.pitch * H)
    assert BlockingRenderer(device="cpu").render(buf, fmt, pscene)
    ref_bytes = np.asarray(jpack.pack_device(
        jnp.asarray(ref.reshape(-1, 3)), jpack.format_key(fmt)))
    diff = np.abs(np.frombuffer(bytes(buf), np.uint8).astype(int)
                  - ref_bytes.reshape(-1).astype(int))
    assert diff.max() <= 1

    # the oracle at seeded pixels: those that hit a simplex, and any, with
    # exact occlusion (the reference's early-out misses occluders of global
    # lights; the engine is any-hit)
    monkeypatch.setattr(kdnodes, "OCCLUDES_EARLY_OUT", False)
    pscene._set_view_size(W, H)
    rng = np.random.RandomState(1)
    ys, xs = np.nonzero(masks["hit"])
    pixels = [(int(xs[i]), int(ys[i])) for i in rng.choice(len(xs), 16)]
    pixels += [(int(x), int(y)) for x, y in rng.randint(0, W, (16, 2))]
    worst = max(float(np.abs(pscene._pixel_color(x, y) - got[y, x]).max())
                for x, y in pixels)
    assert worst < 5e-5, f"worst port-vs-oracle diff {worst}"
