"""Pool (prim) sharding of ntracer_tpu_torch (``parallel.mesh``) on the CPU:
the counterparts of tests/test_engine.py's prim mesh tests, and the cases
where a merge across shards can go wrong.

Each prim shard walks its slice of the pool with its own layouts and the
first device of its px row merges the results (``wavefront._trace_shards``,
``_occlusion_shards``); the CPU mesh repeats the CPU device.  Sharded frames
are held to the port's single-device frame and, twice, to the JAX
package's ``pmesh.render_frame`` on its eight CPU devices (Pallas in
interpret mode): colors within 2e-5, bytes within one code.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ntracer_tpu.parallel import mesh as jmesh
from ntracer_tpu_torch.engine import grid_kernels as gk
from ntracer_tpu_torch.engine import packing
from ntracer_tpu_torch.engine import resident_kernels as prk
from ntracer_tpu_torch.engine import wavefront as pwf
from ntracer_tpu_torch.parallel import mesh as pmesh

from _torch_helpers import (JAX, PORT, _smoke, api, orthoplex_scene,
                            random_scene, reflective_scene, rgb8)
from test_torch_solids import _sphere_pixels

CPU = torch.device("cpu")
EIGHT = [CPU] * 8
TOL = 2e-5


def _codes(colors, fmt):
    return packing.pack_flat(colors.reshape(-1, 3), fmt).astype(int)


def _hold(sharded, ref, fmt, sphere=None):
    """Colors within TOL, bytes within one code; the pixels of ``sphere``
    (whose primary ray meets a sphere) within 1e-4, the bound of the JAX
    frame's FMA in the sphere's discriminant (ROADMAP.md section 3)."""
    if sphere is None:
        sphere = np.zeros(sharded.shape[:2], bool)
    np.testing.assert_allclose(sharded[~sphere], ref[~sphere], rtol=0,
                               atol=TOL)
    assert np.abs(sharded - ref)[sphere].max(initial=0) <= 1e-4
    assert np.abs(_codes(sharded, fmt) - _codes(ref, fmt)).max() <= 1


def _mesh(n_px, n_prim):
    return pmesh.make_mesh(n_px, n_prim, devices=EIGHT)


def _glass_solids_scene(pkg=PORT):
    """tests/test_engine.py's transparent + solids + shadows scene: 600
    triangles (one in ten of glass), a glass cube and an opaque sphere in
    one leaf, a point light, shadows on."""
    smoke = _smoke()
    a = api(pkg)
    nt = a.NTracer(3)
    mat_t = a.Material((0.9, 0.7, 0.4), opacity=0.45)
    rng = np.random.RandomState(41)
    protos = []
    for i in range(600):
        m = mat_t if i % 10 == 0 else a.Material((1, 0.5, 0.5))
        base = rng.uniform(-2, 2, 3)
        pts = [nt.Vector(*(base + rng.uniform(-0.8, 0.8, 3)))
               for _ in range(3)]
        protos.append(nt.TrianglePrototype(pts, m))
    protos.append(nt.SolidPrototype(
        smoke.CUBE, nt.Vector(0.5, 0, -2), nt.Matrix.identity(),
        a.Material((0.4, 0.9, 0.6), opacity=0.5)))
    protos.append(nt.SolidPrototype(
        smoke.SPHERE, nt.Vector(-1.5, 0.5, -1), nt.Matrix.identity(),
        a.Material((0.9, 0.4, 0.6))))
    scene = smoke.leaf_scene(nt, protos, 6.0)
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, -8))
    scene.set_camera(cam)
    scene.add_light(nt.PointLight(nt.Vector(0, 4, -4), (1, 0.8, 0.6)))
    scene.set_shadows(True)
    return scene


def _glass_pool(pkg=PORT):
    """tests/test_engine.py's glass pool over the line: 600 triangles, glass
    and opaque by turns."""
    a = api(pkg)
    nt = a.NTracer(3)
    glass = a.Material((1, 0.7, 0.7), opacity=0.4)
    solid = a.Material((0.3, 0.8, 0.5))
    rng = np.random.RandomState(31)
    protos = []
    for i in range(600):
        base = rng.uniform(-2, 2, 3)
        pts = [nt.Vector(*(base + rng.uniform(-0.5, 0.5, 3)))
               for _ in range(3)]
        protos.append(nt.TrianglePrototype(pts, glass if i % 2 else solid))
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector(0, 0, -8))
    scene.set_camera(cam)
    return scene


def test_kernel_path_two_shard_layouts(monkeypatch):
    """A 2x2 mesh over tests/test_engine.py's 600-triangle scene: each prim
    shard has its own chunked layout (ids global through its
    ``tri_base``), each walk runs once a shard, and the frame equals the
    single device's and the JAX package's sharded frame."""
    w = h = 32
    fmt = rgb8(w, h)
    scene = random_scene(3, n=600, seed=13, spread=0.8)
    single = pwf.frame_colors(scene, w, h, CPU)
    mesh = _mesh(2, 2)
    rows, _cfg = pmesh._mesh_arrays(scene, mesh)
    shards = rows[0]["shards"]
    # one device: both px rows share each shard's arrays
    assert len(rows) == 2 and all(
        a is b for a, b in zip(shards, rows[1]["shards"]))
    assert len(shards) == 2 and all("res_gt" in s for s in shards)
    assert [int(s["tri_base"]) for s in shards] == [0, shards[0]["shard_rows"]]
    calls = []
    inner = prk.nearest_hit
    monkeypatch.setattr(prk, "nearest_hit",
                        lambda *a, **k: calls.append(a[0]["gt"]) or
                        inner(*a, **k))
    sharded = pmesh.render_frame(scene, fmt, mesh)
    assert len(calls) == 4                  # 2 px rows x 2 shards
    assert {id(g) for g in calls} == {id(s["res_gt"]) for s in shards}
    _hold(sharded, single, fmt)
    monkeypatch.setenv("NTRACER_FORCE_KERNELS", "1")
    ref = jmesh.render_frame(random_scene(3, n=600, seed=13, spread=0.8,
                                          pkg=JAX),
                             rgb8(w, h, JAX), jmesh.make_mesh(2, 2))
    _hold(sharded, ref, fmt)


def test_transparent_pool_over_the_line(monkeypatch):
    """Glass over the line at 2x2: every shard streams (its layouts carry
    the opacity rows), and the frame equals the single device's."""
    monkeypatch.setattr(prk, "STREAM_POOL_BYTES", 1024)
    w = h = 32
    fmt = rgb8(w, h)
    scene = _glass_pool()
    single = pwf.frame_colors(scene, w, h, CPU)
    rows, _cfg = pmesh._mesh_arrays(scene, _mesh(2, 2))
    for shard in rows[0]["shards"]:
        assert "res_opa" in shard and "res_is_hbm" in shard
    _hold(pmesh.render_frame(scene, fmt, _mesh(2, 2)), single, fmt)


@pytest.mark.parametrize("n_px,n_prim", [(2, 2), (2, 4)])
def test_transparent_solids_shadows(monkeypatch, n_px, n_prim):
    """Every arm of the merge: the winner, the K slots of several shards,
    the solids on the first shard only (a glass cube counted twice would
    enter the K slots twice and square its filter), ``blocked`` and the
    ``filt`` product over P = 2 and 4 shards.  The 2x4 frame is also held
    to the JAX package's."""
    w = h = 32
    fmt = rgb8(w, h)
    scene = _glass_solids_scene()
    single = pwf.frame_colors(scene, w, h, CPU)
    solid_tests = []
    inner = pwf._solid_test
    monkeypatch.setattr(pwf, "_solid_test", lambda arrs, *a: solid_tests.append(
        arrs) or inner(arrs, *a))
    sharded = pmesh.render_frame(scene, fmt, _mesh(n_px, n_prim))
    shards = pmesh._mesh_arrays(scene, _mesh(n_px, n_prim))[0][0]["shards"]
    assert solid_tests and all(a is shards[0] for a in solid_tests)
    _hold(sharded, single, fmt)
    if n_prim == 4:
        monkeypatch.setenv("NTRACER_FORCE_KERNELS", "1")
        ref = jmesh.render_frame(_glass_solids_scene(JAX), rgb8(w, h, JAX),
                                 jmesh.make_mesh(n_px, n_prim))
        _hold(sharded, ref, fmt, sphere=_sphere_pixels(scene, w))


def test_filt_product_in_shard_order():
    """``filt`` of four shards is multiplied left to right in shard order,
    the order of XLA's product over the all_gather on the CPU."""
    rng = np.random.RandomState(0)
    f = rng.uniform(0.05, 1, (4, 1000)).astype(np.float32)
    want = ((f[0] * f[1]) * f[2]) * f[3]
    import jax
    import jax.numpy as jnp
    got = np.asarray(jax.jit(lambda x: jnp.prod(x, axis=0))(jnp.asarray(f)))
    np.testing.assert_array_equal(got, want)


def test_local_skip_never_matches_another_shard():
    """A bounce ray leaving the triangle of pool id per - 1 or per - 2 of
    shard 0 would reach shard 1 as -1 (no skip) and -2 (the padding slots'
    id) when shifted: both, and every id off the shard, become -1."""
    per = 512
    shard = {"tri_base": torch.tensor(per, dtype=torch.int32),
             "shard_rows": per}
    skip = torch.tensor([per - 1, per - 2, per, 2 * per - 1, 2 * per, -1,
                         3 * per + 1], dtype=torch.int32)
    assert pwf._local_skip(shard, skip).tolist() == [
        -1, -1, 0, per - 1, -1, -1, -1]
    whole = {"tri_base": torch.tensor(0, dtype=torch.int32)}
    assert torch.equal(pwf._local_skip(whole, skip), skip)


def _stack_scene():
    """One leaf in pool order: a large glass triangle (pool id 0, shard 0)
    behind a large opaque one (id 600, shard 1), a second opaque one (id 1,
    shard 0) behind a glass one (id 601, shard 1), and 598 small triangles
    far out of view between them; one global light."""
    smoke = _smoke()
    a = api()
    nt = a.NTracer(3)
    glass = a.Material((1, 0.7, 0.7), opacity=0.4)
    opaque = a.Material((0.3, 0.8, 0.5))

    def big(x0, z, m):
        return nt.TrianglePrototype([nt.Vector(x0 - 3, -3, z),
                                     nt.Vector(x0 + 3, -3, z),
                                     nt.Vector(x0, 3, z)], m)

    rng = np.random.RandomState(3)
    filler = [nt.TrianglePrototype(
        [nt.Vector(*(np.array([40.0, 0, 0]) + rng.uniform(-2, 2, 3)))
         for _ in range(3)], opaque) for _ in range(598)]
    protos = [big(-3, 2, glass), big(3, 2, opaque)] + filler + \
        [big(-3, 0, opaque), big(3, 0, glass)]
    scene = smoke.leaf_scene(nt, protos, 50.0)
    cam = nt.Camera()
    cam.translate(nt.Vector(0, 0, -8))
    scene.set_camera(cam)
    scene.add_light(nt.GlobalLight(nt.Vector(0.3, -1, 0.5), (1, 1, 1)))
    scene.set_shadows(True)
    return scene


def test_trim_after_the_merge():
    """A glass triangle on shard 0 behind an opaque one on shard 1: shard
    0 keeps it in its slots (nothing opaque in front on its own pool), and
    the trim after the merge drops it; a glass triangle on shard 1 in front
    of an opaque one on shard 0 stays.  The frame equals the single
    device's."""
    scene = _stack_scene()
    w = h = 32
    fmt = rgb8(w, h)
    rows, cfg = pmesh._mesh_arrays(scene, _mesh(1, 2))
    top = rows[0]
    assert [s["shard_rows"] for s in top["shards"]] == [512, 512]
    scene._set_view_size(w, h)
    fov, cam_o, cam_t = pwf._camera(scene, w, h, CPU)
    xs = torch.tensor([6.0, 26.0] * 256)
    ys = torch.full((512,), 16.0)
    oT, dT = pwf.make_rays(cam_o, cam_t, *fov, xs, ys)
    skip = torch.full((512,), -1, dtype=torch.int32)
    res = pwf.trace_pool(top, cfg, oT, dT, skip, shared_origin=cam_o)
    left, right = slice(0, 512, 2), slice(1, 512, 2)
    assert (res["pid"][left] == 600).all() and (res["pid"][right] == 1).all()
    assert (res["tidT"][:, left] == -1).all()
    assert (res["tidT"][0, right] == 601).all()
    # shard 0 alone keeps the glass behind shard 1's opaque triangle
    shard0 = top["shards"][0]
    K = cfg.max_transparent_hits
    scfg = dataclasses.replace(cfg, n_tris=512)
    own = pwf._trace_walk(shard0, scfg, oT, dT, skip, True, None,
                          pwf.primary_ctx(shard0, scfg, cam_o), K, None)
    own = pwf._trace_finish_T(shard0, scfg, oT, dT, skip, own, K)
    assert (own["tidT"][0, left] == 0).all()
    _hold(pmesh.render_frame(scene, fmt, _mesh(1, 2)),
          pwf.frame_colors(scene, w, h, CPU), fmt)


def test_bounce_skip_across_shards(monkeypatch):
    """A reflective lit scene at 1x2: bounce and shadow rays leave
    triangles of both shards; each shard's walks see only its own ids or
    -1, and the frame equals the single device's."""
    scene = reflective_scene(shadows=True)
    scene.set_max_reflect_depth(2)
    w = h = 32
    fmt = rgb8(w, h)
    single = pwf.frame_colors(scene, w, h, CPU)
    skips = []
    for name in ("nearest_hit", "occluded"):
        inner = getattr(prk, name)

        def spy(res, oT, dT, *a, _inner=inner, _name=name, **k):
            skips.append((res["gt"], a[0] if _name == "nearest_hit"
                          else a[1]))
            return _inner(res, oT, dT, *a, **k)

        monkeypatch.setattr(prk, name, spy)
    sharded = pmesh.render_frame(scene, fmt, _mesh(1, 2))
    shards = pmesh._mesh_arrays(scene, _mesh(1, 2))[0][0]["shards"]
    per = shards[0]["shard_rows"]
    seen = set()
    for gt, skip in skips:
        j = [id(s["res_gt"]) for s in shards].index(id(gt))
        seen.add(j)
        assert ((skip == -1) | ((skip >= 0) & (skip < per))).all()
    assert seen == {0, 1}
    _hold(sharded, single, fmt)


@pytest.mark.parametrize("d,glass", [(10, False), (9, True)])
def test_d_over_8_prim_sharded(d, glass, monkeypatch):
    """At d > 8 each shard takes the port's own walk: the grid walks (2.9,
    2.10) of an opaque pool, the chunk scan of a glass one (the JAX package
    scans every prim-sharded pool of d > 8, a recorded difference); the
    frames equal the single device's."""
    scene = orthoplex_scene(d, glass=glass,
                            companion="shade" if glass else None)
    w = h = 24
    fmt = rgb8(w, h)
    single = pwf.frame_colors(scene, w, h, CPU)
    shards = pmesh._mesh_arrays(scene, _mesh(1, 2))[0][0]["shards"]
    assert len(shards) == 2
    if glass:
        assert all(pwf._scan(s) for s in shards)
    else:
        assert all(pwf._grid(s) for s in shards)
        calls = []
        inner = gk.nearest_hit
        monkeypatch.setattr(gk, "nearest_hit", lambda *a, **k: calls.append(
            1) or inner(*a, **k))
    sharded = pmesh.render_frame(scene, fmt, _mesh(1, 2))
    if not glass:
        assert len(calls) == 2
    _hold(sharded, single, fmt)


def test_one_prim_shard_keeps_the_single_path():
    """A mesh of one prim shard renders with the scene's own arrays: no
    ``shards``, no merge."""
    scene = random_scene(3, n=600, seed=13, spread=0.8)
    rows, _cfg = pmesh._mesh_arrays(scene, _mesh(4, 1))
    _cfg2, arrs, _flat = pwf.get_device_scene(scene, CPU)
    assert all(r is arrs for r in rows)
    assert "shards" not in arrs
