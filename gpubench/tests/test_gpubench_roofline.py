"""The walk's bound: the frozen copy of chip_smoke.walk_bound and its
helpers against a hand count on a tiny pool, against the originals, its
chunk layout against the port's rows, and its replay's chunk visits
against the port's walk on the same frame."""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from gbench import cell, orbit, spec

from gbench import walkbound as roof  # noqa: E402


def tiny_chunk():
    """One chunk (128 slots) holding the triangle (0,0,0), (1,0,0),
    (0,1,0) in slot 0, the rest empty; 512 rays from (0.2, 0.2, -1), half
    aimed at (0.2, 0.2, 0) (a hit), half at (-0.5, 0.2, 0) (outside edge
    1, the edge along (1,0,0))."""
    tris = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    p1, fn, en, dc = roof.simplex_rows(tris)
    lo, hi = tris.min(axis=1), tris.max(axis=1)
    host = roof.prepare_resident_cells([(lo[0], hi[0], [0])], p1, fn, en, dc,
                                       lo, hi, 3)
    o = torch.tensor([0.2, 0.2, -1.0])
    aim = torch.tensor([[0.2, 0.2, 0.0]] * 256 + [[-0.5, 0.2, 0.0]] * 256)
    dv = aim - o
    dv = dv / dv.norm(dim=1, keepdim=True)
    g = torch.as_tensor(host["gt"])
    ci = roof.shared_rows_res(g, torch.as_tensor(host["ci"]), o, 3)
    return host, g, ci, o, dv


def test_rows_solve_the_triangle():
    host, g, ci, o, dv = tiny_chunk()
    # plane 0 is the face normal; an edge normal meets its own edge at -1
    en1 = host["gt"][0, 3:6, 0]
    assert en1 @ np.array([1, 0, 0]) == pytest.approx(-1)
    assert en1 @ np.array([0, 1, 0]) == pytest.approx(0)


def test_staged_pairs_hand_count():
    host, g, ci, o, dv = tiny_chunk()
    oo = o[:, None, None, None].expand(3, 1, 512, 1)
    dd = dv.T.reshape(3, 1, 512, 1)
    skip = torch.full((1, 512, 1), -1, dtype=torch.int32)
    charged = torch.ones((1, 512), dtype=torch.bool)
    cut = torch.full((1, 512, 1), float("inf"))
    t, valid, counts = roof.staged_pairs(
        3, True, g, ci, torch.as_tensor(host["ids"][:, 0]), oo, dd, skip,
        charged, cut)
    # every slot of every ray is charged; only slot 0 has t > 0; half the
    # rays pass edge 1
    assert counts.tolist() == [512 * 128, 512, 512, 256]
    assert valid.sum() == 256


def test_walk_bound_hand_count():
    need = torch.ones(512, dtype=torch.bool)
    stages = [512 * 128, 512, 512, 256]
    assert roof.pair_ops(3, True) == [5, 10, 7, 8]
    ops = 65536 * 5 + 512 * 10 + 512 * 7 + 256 * 8 + 512 * 1 * 4 * 3
    ms, by = roof.walk_bound(3, True, need, need, stages, 1, 0, 0, 0)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * ops / roof.PEAK_FP32)
    assert 1e3 * 512 * 28 / roof.PEAK_BYTES < ms


@pytest.mark.parametrize("d,shared", [(3, True), (4, False), (6, True)])
def test_frozen_copy_equals_the_original(d, shared):
    assert roof.pair_ops(d, shared) == chip_smoke.pair_ops(d, shared)
    assert (roof.PEAK_FP32, roof.PEAK_BYTES, roof.DIV_OPS) == (
        chip_smoke.PEAK_FP32, chip_smoke.PEAK_BYTES, chip_smoke.DIV_OPS)
    g = torch.Generator().manual_seed(d)
    need = torch.rand(2048, generator=g) > 0.3
    read = need | (torch.rand(2048, generator=g) > 0.5)
    stages = [int(x) for x in torch.randint(0, 10**6, (d + 1,), generator=g)]
    args = (d, shared, need, read, stages, 37, 12345, 4, 999)
    assert roof.walk_bound(*args) == chip_smoke.walk_bound(*args)


def test_layout_rows_match_the_ports():
    from ntracer_tpu_torch import Material, NTracer
    scenes = spec.load_module("scenes", "polytope")
    tris = scenes.polytope_vertices([3, 3, 3])
    tris = scenes.hull_simplices(tris)
    p1, fn, en, dc = roof.simplex_rows(tris)
    src = NTracer(4).TrianglePrototype.batch_from_points(
        tris, Material((1, 1, 1)))._src_arrays
    unit = fn / np.linalg.norm(fn, axis=1, keepdims=True)
    port = src["fn"] / np.linalg.norm(src["fn"], axis=1, keepdims=True)
    np.testing.assert_allclose(np.abs(unit), np.abs(port), atol=1e-6)
    np.testing.assert_allclose(en, src["en"], atol=1e-5)


def test_a_frame_is_counted():
    scenes = spec.load_module("scenes", "polytope")
    tris = scenes.hull_simplices(scenes.polytope_vertices([5, 3, 3]))
    o, ax = orbit.cameras(4, -4.0, {"steps_per_turn": 160, "from": [2],
                                    "to": "others"})
    ms, by, need, visits = roof.bound_of_frame(tris, o[17], ax[17], 0.8,
                                               64, 64, "cpu")
    assert by == "operations" and 0 < ms < 1 and 1000 < need < 4096
    assert visits > 0


@pytest.mark.parametrize("cell_name,tris,step", [
    ("cell120.video1080", None, 17), ("cell120.video1080", None, 90),
    ("mesh500k.orbit1024", 20000, 0), ("mesh500k.orbit1024", 20000, 41)])
def test_the_replay_visits_no_more_than_the_port(cell_name, tris, step):
    """The replay chunks the simplices by their own boxes, the port by the
    k-d cells that hold them: on the same frame the replay visits no more
    chunks than the port's walk counts (``frame_stats``)."""
    from ntracer_tpu_torch import NTracer
    from ntracer_tpu_torch.engine import wavefront
    sp = spec.resolve(spec.load_benchmark(), cell_name)
    conf = spec.merge(sp["config"], {"tris": tris} if tris else None)
    builder = spec.load_module("scenes", conf["builder"])
    d = builder.dimension(conf)
    nt = NTracer(d)
    simplices = spec.simplices(builder, conf)
    scene = cell.build_scene(conf, builder, nt, simplices, {}, "cpu")
    o, ax = orbit.cameras(d, builder.camera_distance(conf),
                          sp["traffic"]["camera"])
    scene.set_camera(cell.camera_objects(nt, o[step:step + 1],
                                         ax[step:step + 1])[0])
    port = wavefront.frame_stats(scene, 96, 64, device="cpu")
    _ms, _by, _need, visits = roof.bound_of_frame(
        simplices, o[step], ax[step], conf["fov"], 96, 64, "cpu")
    assert 0 < visits <= port["chunks_visited"], (visits, port)
