"""The port's grid walks for scenes of more than 8 dimensions (kernels 2.9
and 2.10) and their per-frame prep vs the JAX package's Pallas grid kernels.

The JAX side runs its kernels in interpret mode (the device scene is built
under NTRACER_FORCE_KERNELS).  Both engines get the same rays and the same
layouts, so differences can only come from the walk itself: pool ids and
``blocked`` must agree on every ray.  t is compared to rtol 1e-6 plus the
rounding bound of its numerator: XLA on the CPU contracts a*b+c into FMAs
inside the interpreted kernel, while the twin rounds every operation.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntracer_tpu.engine import pallas_kernels as jpk
from ntracer_tpu.engine import wavefront as jwf
from ntracer_tpu_torch.engine import grid_kernels as gk
from ntracer_tpu_torch.engine import resident_kernels as prk
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import (JAX, orthoplex_scene, generic_scene,
                            jax_device_scene)

W = H = 64
N = 8192              # 16 walk blocks: the frame's first 128 rows of rays
REAL_MAX = float(np.finfo(np.float32).max)

CASES = {
    "orthoplex10": lambda: orthoplex_scene(10, pkg=JAX),
    "orthoplex9": lambda: orthoplex_scene(9, pkg=JAX),
    "generic10": lambda: generic_scene(pkg=JAX),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _targets(rng, flat, n):
    """``n`` seeded points of seeded simplices of the scene, (n, d)."""
    a = flat.arrays
    d = flat.config.d
    real = np.nonzero(np.linalg.norm(a["tri_fn"], axis=1) > 0)[0]
    tri = rng.choice(real, n)
    # the point of the simplex with seeded barycentric weights b, each at
    # least 1 / (2d) (away from the edges, where rounding decides which
    # neighbour is hit): fn . q = -dc and the edge planes'
    # a_i = en_i . p1 - en_i . q = b_i
    w = rng.uniform(1, 2, (n, d))
    b = (w / w.sum(axis=1, keepdims=True))[:, :d - 1]
    m = np.concatenate([a["tri_fn"][tri][:, None], a["tri_en"][tri]],
                       axis=1).astype(np.float64)
    en_p1 = np.einsum("tid,td->ti", a["tri_en"][tri], a["tri_p1"][tri])
    rhs = np.concatenate([-a["tri_dc"][tri][:, None], en_p1 - b], axis=1)
    return np.linalg.solve(m, rhs[:, :, None])[:, :, 0]


def _unit(v):
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """A scene, its JAX device scene (numpy), the port's layouts of it, and
    two ray groups of N rays: ``primary`` rays from the camera (for the
    generic scene, whose simplices the camera's 3-space misses, rays from
    the camera's origin aimed at the simplices) and ``bounce`` rays with
    their own origins, 0.5 to 2 units before seeded points of the
    simplices in seeded directions, half of them skipping the pool id they
    hit first, one block of them dead (origins at infinity, as a bounce
    wavefront's misses are)."""
    mp = pytest.MonkeyPatch()
    scene = CASES[request.param]()
    cfg, arrs, flat = jax_device_scene(scene, mp)
    mp.undo()
    d = cfg.d
    rng = np.random.RandomState(17)
    origin = np.asarray(scene._cam._origin, np.float32)
    if request.param == "generic10":
        o = np.broadcast_to(origin, (N, d)).copy()
        dirs = _unit(_targets(rng, flat, N) - o)
    else:
        scene._set_view_size(W, H)
        fov = jwf._fov_params(W, H, scene.fov)
        xs, ys, _ = jwf._ray_coords(0, W, N)
        o, dirs = jwf.make_rays(jnp.asarray(origin),
                                jnp.asarray(scene._cam._t), *fov, xs, ys)
        o, dirs = np.asarray(o), np.asarray(dirs)
    jk = {k: jnp.asarray(v) for k, v in pwf._kern_dict(arrs).items()}
    pk = {k: _t(v) for k, v in pwf._kern_dict(arrs).items()}

    bd = _unit(rng.normal(size=(N, d)))
    bo = (_targets(rng, flat, N)
          - rng.uniform(0.5, 2.0, (N, 1)) * bd).astype(np.float32)
    _t0, first = jpk.nearest_hit(jk, jnp.asarray(bo), jnp.asarray(bd),
                                 jnp.full((N,), -1, jnp.int32), d)
    first = np.asarray(first)
    bskip = np.where(np.arange(N) % 2 == 0, first, -1).astype(np.int32)
    dead = slice(N - 512, N)
    bo[dead] = bo[dead] + REAL_MAX * bd[dead]
    return dict(name=request.param, cfg=cfg, arrs=arrs, jk=jk, pk=pk, d=d,
                origin=origin, o=o, dirs=dirs, bo=bo, bd=bd, bskip=bskip)


def _t_rounding_bound(o, dirs, ids, arrs, d):
    """Per-ray bound on the rounding error of the winning pair's
    t = (ci0 - o.n) / (d.n), summed over both engines' evaluations."""
    eps = float(np.finfo(np.float32).eps)
    s = np.clip(ids, 0, None)
    g = arrs["kern_gt"][:d, s].T.astype(np.float64)               # (R, d)
    ci0 = arrs["kern_ci"][0, s].astype(np.float64)
    on = np.abs(o * g).sum(axis=1)
    dn = np.abs(dirs * g).sum(axis=1)
    denom = np.abs((dirs * g).sum(axis=1))
    t = np.abs((ci0 - (o * g).sum(axis=1)) / denom)
    return 4 * (d + 2) * eps * ((np.abs(ci0) + on) / denom + t * dn / denom)


def test_prepare_tri_arrays_matches_jax(case):
    """The host prep is a copy: every array equal."""
    scene = CASES[case["name"]]()
    a = jwf.flatten_composite(scene, chunk=jwf.CHUNK).arrays
    got = gk.prepare_tri_arrays(a["tri_p1"], a["tri_fn"], a["tri_en"],
                                a["tri_dc"], a["cull_lo"], a["cull_hi"],
                                case["d"])
    ref = jpk.prepare_tri_arrays(a["tri_p1"], a["tri_fn"], a["tri_en"],
                                 a["tri_dc"], a["cull_lo"], a["cull_hi"],
                                 case["d"])
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k],
                                                               ref[k]), k
    for k, v in pwf._kern_dict(case["arrs"]).items():
        assert np.array_equal(got[k], v), k


def test_port_device_scene_has_the_grid_layouts():
    """At d > 8 the port builds ``tri_pack`` and ``kern_*`` (the JAX
    package's arrays) and no chunked layout."""
    from _torch_helpers import PORT
    cfg, parrs, _ = pwf.get_device_scene(orthoplex_scene(9, pkg=PORT), "cpu")
    jcfg, arrs, _ = jax_device_scene(orthoplex_scene(9, pkg=JAX),
                                     pytest.MonkeyPatch())
    assert cfg.d == 9 and not any(k.startswith("res_") for k in parrs)
    for k in ("tri_pack", "kern_gt", "kern_ci", "kern_klo", "kern_khi",
              "kern_kany", "kern_blo", "kern_bhi"):
        assert np.array_equal(parrs[k].numpy(), arrs[k]), k


def test_shared_rows_and_scene_exit_match_jax(case):
    sh = gk.shared_rows(case["pk"]["gt"], case["pk"]["ci"],
                        _t(case["origin"]), case["d"])
    ref = jpk.shared_rows(case["jk"]["gt"], case["jk"]["ci"],
                          jnp.asarray(case["origin"]), case["d"])
    assert np.array_equal(sh.numpy(), np.asarray(ref))
    for o, dirs in ((case["o"], case["dirs"]), (case["bo"], case["bd"])):
        got = prk._scene_exit_T(_t(o.T), _t(dirs.T), case["pk"]["b_lo"],
                                case["pk"]["b_hi"])
        ref = jpk._scene_exit(jnp.asarray(o), jnp.asarray(dirs),
                              case["jk"]["b_lo"], case["jk"]["b_hi"])
        assert np.array_equal(got.numpy(), np.asarray(ref))
        assert (got > 0).any()


@pytest.mark.parametrize("mode", ["primary", "bounce"])
def test_nearest_hit_ref_matches_pallas(case, mode):
    d = case["d"]
    if mode == "primary":
        o, dirs = case["o"], case["dirs"]
        skip = np.full((N,), -1, np.int32)
        jsh = jpk.shared_rows(case["jk"]["gt"], case["jk"]["ci"],
                              jnp.asarray(case["origin"]), d)
        psh = gk.shared_rows(case["pk"]["gt"], case["pk"]["ci"],
                             _t(case["origin"]), d)
    else:
        o, dirs, skip = case["bo"], case["bd"], case["bskip"]
        jsh = psh = None
    jt, jid = jpk.nearest_hit(case["jk"], jnp.asarray(o), jnp.asarray(dirs),
                              jnp.asarray(skip), d, sh=jsh)
    jt, jid = np.asarray(jt), np.asarray(jid)
    pt, pid, tiles = gk.nearest_hit_ref(case["pk"], _t(o.T), _t(dirs.T),
                                        _t(skip), d, sh=psh)
    pt, pid = pt.numpy(), pid.numpy()
    hits = jid >= 0
    assert hits.sum() > (200 if mode == "primary" else 2000)
    assert np.array_equal(pid, jid)
    bound = _t_rounding_bound(o, dirs, jid, case["arrs"], d)
    with np.errstate(invalid="ignore"):
        assert (np.abs(pt - jt) <= 1e-6 * np.abs(jt) + bound)[hits].all()
    # rays without a hit keep their start distance: exactly the same
    assert np.array_equal(pt[~hits], jt[~hits])
    assert tiles.dtype == torch.int32 and tiles.shape == (N // 512,)
    nj = case["arrs"]["kern_gt"].shape[1] // 512
    assert int(tiles.max()) <= nj and int(tiles.max()) > 0
    if mode == "bounce":
        skips = skip >= 0
        assert (jid[skips] != skip[skips]).all()
        if case["name"] != "generic10":
            # a convex body: the skipping rays find its back face
            assert (jid[skips] >= 0).sum() > 1000
        assert int(tiles[-1]) == 0          # the dead block runs no tile


def _shadow_inputs(case, light):
    """Shadow rays from the bounce group's hit points (skipping the surface
    they lie on), misses and the dead block inactive: towards the scene's
    point light (finite distances), along its global light (REAL_MAX,
    unclamped, as the grid branch sends it), or none at all (``dead``).
    The engine casts a point light's shadow ray from the point away from
    the light, and the bounce rays' hit points lie all around the body, so
    both lights' rays often cross it."""
    d = case["d"]
    jt, jid = jpk.nearest_hit(case["jk"], jnp.asarray(case["bo"]),
                              jnp.asarray(case["bd"]),
                              jnp.full((N,), -1, jnp.int32), d)
    jt, jid = np.asarray(jt), np.asarray(jid)
    hit = jid >= 0
    p = np.where(hit[:, None], case["bo"] + jt[:, None] * case["bd"], 0) \
        .astype(np.float32)
    if light == "global":
        ld = np.broadcast_to(-case["arrs"]["gl_dir"][0], p.shape)
        return p, np.ascontiguousarray(ld), \
            np.where(hit, REAL_MAX, 0).astype(np.float32), jid
    pos = case["arrs"]["pl_pos"][0]
    lv = p - pos
    dist = np.sqrt((lv * lv).sum(axis=1)).astype(np.float32)
    ld = (lv / dist[:, None]).astype(np.float32)
    ldist = np.where(hit & (light != "dead"), dist, 0).astype(np.float32)
    return p, ld, ldist, jid


@pytest.mark.parametrize("light", ["point", "global", "dead"])
def test_occluded_ref_matches_pallas(case, light):
    d = case["d"]
    p, ld, ldist, skip = _shadow_inputs(case, light)
    ref = np.asarray(jpk.occluded(case["jk"], jnp.asarray(p),
                                  jnp.asarray(ld), jnp.asarray(ldist),
                                  jnp.asarray(skip), d))
    got, tiles = gk.occluded_ref(case["pk"], _t(p.T), _t(ld.T), _t(ldist),
                                 _t(skip), d)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), ref)
    if light == "dead":
        assert not ref.any() and not tiles.any()
    elif case["name"] != "generic10":
        assert 1000 < ref.sum() < (ldist > 0).sum()


def test_wrappers_take_the_twins_on_cpu(case):
    d = case["d"]
    args = (case["pk"], _t(case["bo"].T), _t(case["bd"].T))
    skip = _t(case["bskip"])
    n0, o0 = gk.nearest_hit.launches, gk.occluded.launches
    got = gk.nearest_hit(*args, skip, d)
    ref = gk.nearest_hit_ref(*args, skip, d)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    ldist = torch.full((N,), 2.0)
    got = gk.occluded(*args, ldist, skip, d)
    ref = gk.occluded_ref(*args, ldist, skip, d)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert (gk.nearest_hit.launches, gk.occluded.launches) == (n0, o0)


def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    d = case["d"]
    o = torch.zeros((d, 100))
    skip = torch.zeros(100, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 512"):
        gk.nearest_hit(case["pk"], o, o, skip, d)
    with pytest.raises(ValueError, match="multiple of 512"):
        gk.occluded(case["pk"], o, o, torch.ones(100), skip, d)
    meta = {k: v.to("meta") for k, v in case["pk"].items()}
    om = torch.zeros((d, 512), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gk.nearest_hit(meta, om, om, torch.zeros(512, dtype=torch.int32,
                                                 device="meta"), d)
    w = gk._grid_inputs(case["pk"], torch.zeros((d, 512)),
                        torch.zeros((d, 512)),
                        torch.zeros(512, dtype=torch.int32), d)
    assert gk._check_grid(w, torch.device("cpu")) == (
        512, case["arrs"]["kern_gt"].shape[1])
    # the CUDA kernels take any d >= 3 (past 16 their wide bodies), and no
    # smaller d
    for dd in (gk.WIDE_D, 2):
        z = np.zeros((gk.TRI_BLOCK, dd), np.float32)
        kern = {k: torch.from_numpy(v) for k, v in gk.prepare_tri_arrays(
            z, z, np.zeros((gk.TRI_BLOCK, dd - 1, dd), np.float32),
            z[:, 0], z, z, dd).items()}
        w = gk._grid_inputs(kern, torch.zeros((dd, 512)),
                            torch.zeros((dd, 512)),
                            torch.zeros(512, dtype=torch.int32), dd)
        if dd < 3:
            with pytest.raises(ValueError, match="d >= 3"):
                gk._check_grid(w, torch.device("cpu"))
        else:
            assert gk._check_grid(w, torch.device("cpu")) == (512, 512)
