"""Scenes past 8-D through ntracer_tpu_torch's user path, against the
benchmark's plain reference (``gpubench/gbench/reference.py``: plain
float64 torch, opaque simplices, the camera light, which imports nothing of
the program), and the grid walks' tile counters.

The 10-orthoplex of ``gpubench/configs/polytope_orthoplex_d10.json`` is
rendered by ``BlockingRenderer`` into a small 16-bit buffer with the
cameras of the ``video1080`` mix (``gpubench/gbench/orbit.py``): at step 0,
where every ray lies in x3 = ... = x9 = 0 and meets the polytope on faces
shared by 2^7 facets, and at three steps drawn from seeds.  A pool of
random 10-D simplices is rendered the same way.  Each frame's share of
pixels off by more than one unit must stay under the orthoplex cell's
limit (``gpubench/checks/orth10.video1080.json``).  No module here imports
JAX.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from _torch_helpers import REPO, lit_scene_3d, orthoplex_scene

BENCH = os.path.join(REPO, "gpubench")
CELL = "orth10.video1080"
SIDE_W, SIDE_H = 64, 48
SEEDS = (2147483693, 3141592653, 977)


def _load(rel):
    path = os.path.join(BENCH, rel)
    spec = importlib.util.spec_from_file_location(
        "orth10_" + os.path.basename(rel)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


reference = _load("gbench/reference.py")
orbit = _load("gbench/orbit.py")
polytope = _load("scenes/polytope.py")


def _json(rel):
    with open(os.path.join(BENCH, rel)) as f:
        return json.load(f)


CONFIG = _json("configs/polytope_orthoplex_d10.json")
CAMERA = _json("traffic/video1080.json")["camera"]
LIMIT = _json(f"checks/{CELL}.json")["limit"]


def _scene(tris):
    """The scene of ``tris`` as the benchmark builds it: the prototypes of
    ``scenes/polytope.py``, ``build_composite_scene`` and the
    configuration's settings."""
    from ntracer_tpu_torch import NTracer
    nt = NTracer(tris.shape[1])
    scene = nt.build_composite_scene(polytope.prototypes(CONFIG, nt, tris,
                                                         None))
    scene.set_fov(CONFIG["fov"])
    bg = CONFIG["background"]
    scene.set_background(tuple(bg["bg1"]), tuple(bg["bg2"]),
                         tuple(bg["bg3"]), bg["axis"])
    scene.set_ambient_color(tuple(CONFIG["ambient"]))
    scene.set_camera_light(CONFIG["camera_light"])
    return nt, scene


def _camera(nt, origin, axes):
    cam = nt.Camera()
    cam.origin = nt.Vector(*origin.tolist())
    for i in range(len(axes)):
        cam.axes[i] = nt.Vector(*axes[i].tolist())
    return cam


def _off_share(tris, origin, axes):
    """Render ``tris`` from the float32 camera through ``BlockingRenderer``
    into a 16-bit buffer; returns (the share of pixels off the reference by
    more than one unit, the share of pixels whose ray hits a simplex)."""
    from ntracer_tpu_torch import BlockingRenderer, Channel, ImageFormat
    nt, scene = _scene(tris)
    scene.set_camera(_camera(nt, origin, axes))
    fmt = ImageFormat(SIDE_W, SIDE_H, [Channel(16, 1, 0, 0),
                                       Channel(16, 0, 1, 0),
                                       Channel(16, 0, 0, 1)])
    assert fmt.pitch == SIDE_W * 6
    buf = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer(device="cpu").render(buf, fmt, scene)
    got = np.frombuffer(bytes(buf), ">u2").reshape(SIDE_H, SIDE_W, 3)
    xs, ys = np.meshgrid(np.arange(SIDE_W), np.arange(SIDE_H))
    xs, ys = xs.ravel(), ys.ravel()
    want = reference.pixels(tris, CONFIG, origin, axes, SIDE_W, SIDE_H, xs,
                            ys, 16).numpy()
    diff = np.abs(got.reshape(-1, 3).astype(np.int64) - want).max(axis=1)
    rows = reference.simplex_rows(tris, torch.float64, "cpu")
    dirs = reference.pixel_rays(origin, axes, CONFIG["fov"], SIDE_W, SIDE_H,
                                xs, ys, torch.float64, "cpu")
    _t, idx = reference.nearest(rows, origin, dirs, 4096)
    return float((diff > 1).mean()), float((idx >= 0).float().mean())


def _orthoplex():
    return polytope.simplices(CONFIG, None)


def test_the_cell_is_the_orthoplex():
    tris = _orthoplex()
    assert tris.shape == (1024, 10, 10)
    assert polytope.dimension(CONFIG) == 10


@pytest.mark.parametrize("step", [0] + [orbit.start_step(CAMERA, s)
                                        for s in SEEDS])
def test_orthoplex_frame_matches_the_reference(step):
    origins, axes = orbit.cameras(10, polytope.camera_distance(CONFIG),
                                  CAMERA)
    if step == 0:
        # the path starts in the 3-space of axes 0-2
        assert not axes[0][:3, 3:].any() and not origins[0][3:].any()
    off, hit = _off_share(_orthoplex(), origins[step], axes[step])
    assert hit > 0.1
    assert off <= LIMIT, (step, off)


def test_random_10d_pool_matches_the_reference():
    """Random 10-D simplices, each centred on a ray of the upstream start
    camera or of a later step of the path, seen from both cameras."""
    rng = np.random.default_rng(1010)
    origins, axes = orbit.cameras(10, -4.0, CAMERA)
    steps = (0, 37)
    tris = []
    for step in steps:
        ax = axes[step].astype(np.float64)
        for _ in range(30):
            a, b = rng.uniform(-0.3, 0.3, 2)
            centre = origins[step] + rng.uniform(3, 5) * (
                ax[2] + a * ax[0] + b * ax[1])
            v = rng.uniform(-1, 1, (10, 10))
            tris.append(centre + v - v.mean(axis=0))
    tris = np.asarray(tris, np.float32)
    for step in steps:
        off, hit = _off_share(tris, origins[step], axes[step])
        assert hit > 0.1
        assert off <= LIMIT, (step, off)


def _primary_tiles(scene, w, h):
    """The tiles the CPU twin of kernel 2.9 runs a block on the primary
    rays of a ``w`` x ``h`` frame, made as the frame makes them."""
    from ntracer_tpu_torch.engine import grid_kernels as gk
    from ntracer_tpu_torch.engine import wavefront as pwf
    cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    fov, cam_o, cam_t = pwf._camera(scene, w, h, "cpu")
    groups = pwf._frame_groups(-(-(w * h) // pwf.TILE))
    xs, ys, _unswizzle = pwf._frame_coords(groups, w, "cpu")
    oT, dT = pwf.make_rays(cam_o, cam_t, *fov, xs, ys)
    sh = gk.shared_rows(arrs["kern_gt"], arrs["kern_ci"], cam_o, cfg.d)
    skip = torch.full((oT.shape[1],), -1, dtype=torch.int32)
    return gk.nearest_hit_ref(pwf._kern_dict(arrs), oT, dT, skip, cfg.d,
                              sh=sh)[2]


@pytest.mark.parametrize("step", [0, orbit.start_step(CAMERA, SEEDS[0])])
def test_grid_tiles_visited_is_the_twins_tiles(step):
    from ntracer_tpu_torch.engine import wavefront as pwf
    origins, axes = orbit.cameras(10, polytope.camera_distance(CONFIG),
                                  CAMERA)
    nt, scene = _scene(_orthoplex())
    scene.set_camera(_camera(nt, origins[step], axes[step]))
    stats = pwf.frame_stats(scene, SIDE_W, SIDE_H, "cpu")
    tiles = _primary_tiles(scene, SIDE_W, SIDE_H)
    assert stats["grid_tiles_visited"] == int(tiles.sum()) > 0
    # the scene casts no shadow: no occlusion walk ran
    assert "occl_grid_tiles_visited" not in stats


def test_a_lit_10d_frame_counts_its_shadow_tiles():
    from ntracer_tpu_torch.engine import wavefront as pwf
    stats = pwf.frame_stats(orthoplex_scene(10), 32, 32, "cpu")
    assert stats["grid_tiles_visited"] > 0
    assert stats["occl_grid_tiles_visited"] > 0


@pytest.mark.parametrize("make", [
    lambda: lit_scene_3d(),
    lambda: orthoplex_scene(9, glass=True),
], ids=["chunk_walks_3d", "chunk_scan_9d"])
def test_other_walks_count_no_grid_tiles(make):
    from ntracer_tpu_torch.engine import wavefront as pwf
    stats = pwf.frame_stats(make(), 32, 32, "cpu")
    assert stats["rays_traced"] > 0
    assert not {"grid_tiles_visited", "occl_grid_tiles_visited"} & set(stats)
