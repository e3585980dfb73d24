"""The per-frame counters of ntracer_tpu_torch (``stats``, ``frame_stats``)
against the JAX package's ``ray_colors(..., with_stats=True)``.

Both engines trace the same rays (the JAX package's, as numpy) over scenes
of their own package built from one seed; the JAX side runs its Pallas walks
in interpret mode (NTRACER_FORCE_KERNELS=1, as tests/test_pallas.py's
``test_ray_colors_stats`` runs it).  The counts must be equal: rays traced
and chunk visits of the walks (2.1, 2.3; 2.5, 2.7 over the line), shadow
rays and their visits (2.2, 2.4; 2.6, 2.8), the bounce counters, the grid
walk's rays and the chunk scan's chunk runs.  The grid walks' tiles (2.9,
2.10) are the port's own counters, which the JAX package lacks: they are
taken out before the comparison and held to the tiles the walks returned.
The pools over the line are in tests/test_torch_stats_hbm.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntracer_tpu.engine import resident_kernels as jrk
from ntracer_tpu.engine import wavefront as jwf
from ntracer_tpu_torch.engine import graphs as pgraphs
from ntracer_tpu_torch.engine import grid_kernels as pgk
from ntracer_tpu_torch.engine import resident_kernels as prk
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import (JAX, PORT, glass_scene, lit_scene_3d,
                            orthoplex_scene, reflective_scene)

SIDE = 32
# the port's counters of the grid walks, by the walk whose tiles each sums
GRID_COUNTERS = {"grid_tiles_visited": "nearest_hit",
                 "occl_grid_tiles_visited": "occluded"}

SCENES = {
    # name: (scene of package pkg, rays, over the line)
    "lit": (lambda pkg: lit_scene_3d(pkg=pkg), 512, False),
    "lit_glass": (lambda pkg: glass_scene(300, lit=True, pkg=pkg), 512,
                  False),
    "reflective": (lambda pkg: reflective_scene(shadows=True, pkg=pkg), 1024,
                   False),
    "opaque_10d": (lambda pkg: orthoplex_scene(10, pkg=pkg), 1024, False),
    "glass_9d": (lambda pkg: orthoplex_scene(9, pkg=pkg, glass=True), 512,
                 False),
}


def _counts(stats):
    return {k: int(v) for k, v in stats.items()}


def _tiles_walked(monkeypatch):
    """Wrap the port's grid walks; returns {walk: the tiles its calls
    returned, summed over calls and blocks}."""
    walked = dict.fromkeys(GRID_COUNTERS.values(), 0)
    for walk in walked:
        def wrapped(*args, _inner=getattr(pgk, walk), _walk=walk, **kw):
            out = _inner(*args, **kw)
            walked[_walk] += int(out[-1].sum())
            return out
        monkeypatch.setattr(pgk, walk, wrapped)
    return walked


def _both(name, monkeypatch, scenes=SCENES):
    """The JAX and the port's counters of the rays of ``scenes[name]``, and
    the tiles the port's grid walks returned (``_tiles_walked``)."""
    make, n, over = scenes[name]
    monkeypatch.setenv("NTRACER_FORCE_KERNELS", "1")
    if over:
        monkeypatch.setattr(jrk, "POOL_VMEM_BUDGET", 1024)
        monkeypatch.setattr(prk, "STREAM_POOL_BYTES", 1024)
    jscene, pscene = make(JAX), make(PORT)
    if name == "reflective":
        for s in (jscene, pscene):
            s.set_max_reflect_depth(2)
    jcfg, jdev, _ = jwf.get_device_scene(jscene)
    pcfg, parrs, _ = pwf.get_device_scene(pscene, "cpu")
    assert ("res_is_hbm" in jdev) == ("res_is_hbm" in parrs) == over
    idx = np.arange(n)
    xs = jnp.asarray((idx % SIDE).astype(np.float32))
    ys = jnp.asarray(((idx // SIDE) % SIDE).astype(np.float32))
    jscene._set_view_size(SIDE, SIDE)
    fov = jwf._fov_params(SIDE, SIDE, jscene.fov)
    o, dirs = jwf.make_rays(jnp.asarray(jscene._cam._origin),
                            jnp.asarray(jscene._cam._t), *fov, xs, ys)
    _colors, jstats = jwf.ray_colors(jdev, jcfg, jwf._scene_dyn(jscene), o,
                                     dirs, with_stats=True)
    oT = torch.from_numpy(np.ascontiguousarray(np.asarray(o).T))
    dT = torch.from_numpy(np.ascontiguousarray(np.asarray(dirs).T))
    pstats = {}
    walked = _tiles_walked(monkeypatch)
    pwf._ray_colors_T(parrs, pcfg, pwf._scene_dyn(pscene, "cpu"), oT, dT,
                      stats=pstats)
    return _counts(jstats), _counts(pstats), pcfg, parrs, walked


@pytest.mark.parametrize("name", sorted(SCENES))
def test_stats_match_jax(name, monkeypatch):
    check_stats(name, monkeypatch, SCENES)


def check_stats(name, monkeypatch, scenes):
    """The port's counts of ``scenes[name]`` equal the JAX package's, but
    for the grid walks' tiles, which equal the tiles the walks returned."""
    jstats, pstats, pcfg, parrs, walked = _both(name, monkeypatch, scenes)
    print(name, pstats)
    grid = {k: pstats.pop(k) for k in GRID_COUNTERS if k in pstats}
    assert pstats == jstats
    n = scenes[name][1]
    assert pstats["rays_traced"] >= n
    if pwf._grid(parrs):
        # the JAX package's grid branches count rays only; the port's count
        # every tile its walks ran, and the lit scene's shadow queries ran
        # some
        assert not any(k.endswith("chunks_visited") or k == "shadow_rays"
                       for k in pstats)
        assert grid == {k: walked[w] for k, w in GRID_COUNTERS.items()}
        tiles = parrs["kern_gt"].shape[1] // pgk.TRI_BLOCK
        assert 0 < grid["grid_tiles_visited"] <= tiles * n // prk.RAY_BLOCK
        assert grid["occl_grid_tiles_visited"] > 0
    else:
        assert grid == {} and walked == dict.fromkeys(walked, 0)
        assert pstats["chunks_visited"] > 0
        assert pstats["shadow_rays"] > 0 and pstats["occl_chunks_visited"] > 0
    if pcfg.has_reflectivity:
        assert pstats["bounce_live_rays_d1"] > 0
        assert 0 < pstats["bounce_live_blocks_d1"] <= n // prk.RAY_BLOCK


def test_frame_stats_sum_of_groups(monkeypatch):
    """``frame_stats`` renders the frame's groups (``_frame_groups``) in one
    pass: its counts are the sums of the counts of each group rendered
    alone, and it traces every ray of the frame's whole TILEs.  TILE is
    lowered to 1,024 rays so that a small frame has several slabs and
    groups."""
    monkeypatch.setattr(pwf, "TILE", 1024)
    scene = lit_scene_3d()
    w, h = 128, 128
    groups = pwf._frame_groups(-(-(w * h) // pwf.TILE))
    assert len(groups) == 4
    got = pwf.frame_stats(scene, w, h, "cpu")
    assert got["rays_traced"] == sum(c for _s, c in groups) == 16 * 1024
    cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    fov, cam_o, cam_t = pwf._camera(scene, w, h, "cpu")
    dyn = pwf._scene_dyn(scene, "cpu")
    total = {}
    for group in groups:
        pwf._frame_packed_composite(arrs, cfg, dyn, cam_o, cam_t, fov,
                                    [group], w, None, stats=total)
    # the frame's own counters: a CPU frame runs eagerly, from no graphs
    assert {k: got.pop(k) for k in pgraphs.COUNTERS} == dict.fromkeys(
        pgraphs.COUNTERS, 0)
    assert got == _counts(total)
    assert got["shadow_rays"] > 0


def test_frame_stats_refuses_box_scene():
    from ntracer_tpu_torch import NTracer
    with pytest.raises(TypeError):
        pwf.frame_stats(NTracer(4).BoxScene(), 16, 16, "cpu")


def test_no_counters_no_ops():
    """A frame without ``stats`` runs none of the counters' ops: no sum of
    a mask or of a visit count (the frame's own sums are of float rows),
    and the same ops as a frame whose counters are computed and dropped
    would run less theirs.  With ``stats`` the sums appear."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.int_sums = 0
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            if func.overloadpacket is torch.ops.aten.sum and \
                    not args[0].is_floating_point():
                self.int_sums += 1
            return func(*args, **(kwargs or {}))

    scene = reflective_scene(shadows=True)
    scene.set_max_reflect_depth(2)
    plain, counted = Ops(), Ops()
    with plain:
        a = pwf.frame_colors(scene, 32, 32, "cpu")
    with counted:
        stats = {}
        b = pwf._frame(scene, 32, 32, None, "cpu", stats=stats)
    assert plain.int_sums == 0
    assert counted.int_sums > 0 and counted.ops > plain.ops
    np.testing.assert_array_equal(
        a, b[:32 * 32].numpy().reshape(32, 32, 3))
