"""The grid walk's bound (``gbench/gridbound.py``): a hand count on a
two-tile pool, the frozen copy against the originals it was copied from
(chip_smoke.py's pool, stages and bound; the port's shared rows), and its
replay's tiles a block against the port's walk on the orthoplex cell's
frames: on the CPU (the walk's twin) at a small size, and (marked ``gpu``)
against kernel 2.9 at the cell's size."""

import numpy as np
import pytest
import torch

import chip_smoke
from gbench import cell, gridbound, orbit, spec
from gbench import walkbound as wb

CELL = "orth10.video1080"


def two_tile_walk():
    """Triangle A = (0,0,0), (1,0,0), (0,1,0) alone in tile 0 and triangle
    B, A moved to z = 1, alone in tile 1; two 512-ray blocks from (0.2,
    0.2, -1).  Block 0: 128 rays along z (through A at t = 1, B behind it
    at t = 2) and 128 rays aimed at (0.55, 0.55, 0) (inside A's box but
    outside A, then inside B's box but outside B), the rest and block 1
    pointing away from the pool."""
    tris = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                       [[0, 0, 1], [1, 0, 1], [0, 1, 1]]], np.float32)
    one = gridbound.grid_pool(tris, "cpu")
    pool = {"gt": torch.zeros((9, 1024)), "ci": torch.zeros((3, 1024))}
    for k in ("gt", "ci"):
        pool[k][:, 0] = one[k][:, 0]
        pool[k][:, 512] = one[k][:, 1]
    pool.update(k_lo=torch.as_tensor(tris.min(axis=1)),
                k_hi=torch.as_tensor(tris.max(axis=1)),
                k_any=torch.ones(2), b_lo=one["b_lo"], b_hi=one["b_hi"])
    o = torch.tensor([0.2, 0.2, -1.0])
    dirs = torch.tensor([[0.0, 0.0, 1.0]] * 128 + [[0.35, 0.35, 1.0]] * 128
                        + [[0.0, 0.0, -1.0]] * 768)
    dT = (dirs / dirs.norm(dim=1, keepdim=True)).T.contiguous()
    oT = o[:, None].expand(3, 1024).contiguous()
    init_t = wb._scene_exit_T(oT, dT, pool["b_lo"], pool["b_hi"])
    sh = gridbound.shared_rows(pool["gt"], pool["ci"], o, 3)
    return dict(pool, d=3, oT=oT, dT=dT, init_t=init_t, sh=sh)


def test_two_tile_pool_hand_count():
    w = two_tile_walk()
    need = w["init_t"] > 0
    assert need.sum() == 256
    ms, by, n, tiles = gridbound.bound_of_walk(w)
    # block 0 runs tile 0 (its rays enter A's box before their pool exit)
    # and tile 1 (the rays past A enter B's box before their pool exit, the
    # rays through A do not: their nearest hit, 1, comes first); block 1
    # runs none
    assert tiles.tolist() == [2, 0] and n == 256
    cut = torch.nextafter(torch.where(torch.arange(1024) < 128, 1.0,
                                      w["init_t"]), torch.tensor(np.inf))
    stages, best, _tiles = gridbound.walk_tiles(w, need, cut)
    assert torch.equal(best[:128], torch.ones(128))
    assert torch.equal(best[128:], w["init_t"][128:])
    # tile 0: every slot of the 256 charged rays; A's pair divides, has t
    # in range and passes edge 1 for all 256.  Tile 1: B's pair divides for
    # all 256, and only the 128 rays past A have it before their nearest
    assert stages == [2 * 256 * 512, 2 * 256, 256 + 128, 256 + 128]
    ops = (2 * 256 * 512 * 5 + 512 * 10 + 384 * 7 + 384 * 8
           + 256 * 2 * 4 * 3)
    assert gridbound.pool_bytes(w) == 4 * (9 * 1024 + 3 * 1024 + 6 + 6 + 2)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * ops / wb.PEAK_FP32)
    assert 1e3 * (2 * 512 * 28 + 49208 + 8200) / wb.PEAK_BYTES < ms


def orthoplex(d=10):
    scenes = spec.load_module("scenes", "polytope")
    return scenes.hull_simplices(scenes.polytope_vertices([3] * (d - 2)
                                                          + [4]))


def test_frozen_copy_equals_the_original():
    """gridbound's pool is chip_smoke.simplex_pool's (the port's
    prepare_tri_arrays on the simplices' own boxes); its shared rows the
    port's; its stages chip_smoke.grid_walk_stages' and its bound
    chip_smoke.walk_bound's, on the same rays."""
    from ntracer_tpu_torch.engine import grid_kernels as gk
    tris = orthoplex(9)
    pool = gridbound.grid_pool(tris, "cpu")
    arrs = chip_smoke.simplex_pool(tris, "cpu")
    for mine, theirs in (("gt", "kern_gt"), ("ci", "kern_ci"),
                         ("b_lo", "kern_blo"), ("b_hi", "kern_bhi")):
        torch.testing.assert_close(pool[mine], arrs[theirs], rtol=0,
                                   atol=2e-6)
    for mine, theirs in (("k_lo", "kern_klo"), ("k_hi", "kern_khi"),
                         ("k_any", "kern_kany")):
        assert torch.equal(pool[mine], arrs[theirs].reshape(pool[mine].shape))
    o, ax = orbit.cameras(9, -4.0, {"steps_per_turn": 160, "from": [2],
                                    "to": "others"})
    w = gridbound.frame_walk(tris, o[23], ax[23], 0.8, 64, 32, "cpu")
    assert torch.equal(w["sh"], gk.shared_rows(w["gt"], w["ci"],
                                               w["oT"][:, 0], 9))
    ms, by, need, tiles = gridbound.bound_of_walk(w)
    kern = dict(w, k_lo=w["k_lo"][:, None], k_hi=w["k_hi"][:, None],
                k_any=w["k_any"][:, None, None])
    skip = torch.full((w["oT"].shape[1],), -1, dtype=torch.int32)
    kt, _kid, ktl = gk.nearest_hit_ref(kern, w["oT"], w["dT"], skip, 9,
                                       sh=w["sh"])
    assert torch.equal(tiles, ktl)
    stages = chip_smoke.grid_walk_stages(kern, w["oT"], w["dT"], skip, 9,
                                         ktl, sh=w["sh"], t=kt)
    hit = w["init_t"] > 0
    assert (ms, by) == chip_smoke.walk_bound(
        9, True, hit, torch.ones_like(hit), stages, 1,
        chip_smoke.grid_pool_bytes(arrs), 0, w["oT"].shape[1] * 8
        + ktl.numel() * 4)
    assert need == int(hit.sum()) > 0


def _port_tiles(name, step, width, height, device, monkeypatch):
    """The tiles a block of the port's primary grid walk on the cell's
    frame ``step`` (``gk.nearest_hit`` in an eager frame of
    ``frame_stats``), and the frame's counters."""
    from ntracer_tpu_torch import NTracer
    from ntracer_tpu_torch.engine import grid_kernels as gk
    from ntracer_tpu_torch.engine import wavefront
    sp = spec.resolve(spec.load_benchmark(), name)
    conf = sp["config"]
    builder = spec.load_module("scenes", conf["builder"])
    nt = NTracer(10)
    tris = spec.simplices(builder, conf)
    scene = cell.build_scene(conf, builder, nt, tris, {}, device)
    o, ax = orbit.cameras(10, builder.camera_distance(conf),
                          sp["traffic"]["camera"])
    scene.set_camera(cell.camera_objects(nt, o[step:step + 1],
                                         ax[step:step + 1])[0])
    got = []
    inner = gk.nearest_hit

    def nearest_hit(*args, **kw):
        out = inner(*args, **kw)
        got.append(out[-1].clone())
        return out
    # the kernel's launch counter counts on the name it is called by
    nearest_hit.launches = 0
    monkeypatch.setattr(gk, "nearest_hit", nearest_hit)
    stats = wavefront.frame_stats(scene, width, height, device)
    assert len(got) == 1
    return got[0], stats, (tris, o[step], ax[step], conf["fov"])


def _check_step(step, width, height, device, monkeypatch):
    port, stats, (tris, o, ax, fov) = _port_tiles(CELL, step, width, height,
                                                  device, monkeypatch)
    _ms, _by, need, tiles = gridbound.bound_of_frame(tris, o, ax, fov, width,
                                                     height, device)
    assert torch.equal(tiles.cpu(), port.cpu()), (
        int((tiles.cpu() != port.cpu()).sum()))
    assert stats["grid_tiles_visited"] == int(tiles.sum()) > 0
    return need, tiles


@pytest.mark.parametrize("step", [0, 17, 118])
def test_the_replay_runs_the_ports_tiles(step, monkeypatch):
    need, tiles = _check_step(step, 96, 64, "cpu", monkeypatch)
    assert need > 0 and tiles.max() == 2


@pytest.mark.gpu
@pytest.mark.parametrize("step", [0, 61, 140])
def test_the_replay_runs_the_kernels_tiles_at_the_cells_size(step, card,
                                                             monkeypatch):
    need, tiles = _check_step(step, 1920, 1080, "cuda:0", monkeypatch)
    print(f"{CELL} step {step}: {need} rays to test, {int(tiles.sum())} "
          f"tiles over {tiles.numel()} blocks, equal to kernel 2.9's")
