"""The plain reference against the port's scalar oracle (the exact port of
upstream's per-pixel semantics) on small frames on the CPU."""

import numpy as np
import torch

from gbench import check, orbit, reference, spec

W = H = 48


def scene_and_tris(cell_name, tris_override=None):
    from ntracer_tpu_torch import NTracer
    sp = spec.resolve(spec.load_benchmark(), cell_name)
    config = spec.merge(sp["config"], tris_override)
    builder = spec.load_module("scenes", config["builder"])
    tris = builder.simplices(config, None)
    d = builder.dimension(config)
    nt = NTracer(d)
    if config["builder"] == "polytope":
        protos = builder.prototypes(config, nt, tris, None)
    else:
        protos = nt.TrianglePrototype.batch_from_points(
            tris, __import__("ntracer_tpu_torch").Material((1, 1, 1)))
    scene = nt.build_composite_scene(protos)
    scene.set_fov(config["fov"])
    cams = orbit.cameras(d, builder.camera_distance(config),
                         sp["traffic"]["camera"])
    return nt, scene, config, tris, cams


def oracle(scene, nt, origin, axes, xs, ys):
    cam = nt.Camera()
    cam.origin = nt.Vector(*origin.tolist())
    for i in range(len(axes)):
        cam.axes[i] = nt.Vector(*axes[i].tolist())
    scene.set_camera(cam)
    out = []
    for x, y in zip(xs, ys):
        c = scene.calculate_color(int(x), int(y), W, H)
        out.append([c.r, c.g, c.b])
    return np.asarray(out, np.float32)


def test_reference_matches_the_oracle_on_the_120cell():
    nt, scene, config, tris, (origins, axes) = scene_and_tris(
        "cell120.video1080")
    xs, ys = check.sample_pixels(5, 0, W, H, 96)
    off = 0
    for step in (7, 61):
        want = oracle(scene, nt, origins[step], axes[step], xs, ys)
        want = np.floor(np.clip(want, 0, 1).astype(np.float64) * 255 + 0.5)
        got = reference.pixels(tris, config, origins[step], axes[step], W, H,
                               xs, ys, 8).numpy()
        diff = np.abs(got - want).max(axis=1)
        assert diff.max() <= 1 or (diff > 1).sum() <= 1
        off += int((diff > 1).sum())
    assert off <= 1


def test_reference_matches_the_oracle_on_a_sphere():
    nt, scene, config, tris, (origins, axes) = scene_and_tris(
        "mesh500k.orbit1024", {"tris": 3000})
    xs, ys = check.sample_pixels(6, 0, W, H, 96)
    step = 9
    want = oracle(scene, nt, origins[step], axes[step], xs, ys)
    want = np.floor(np.clip(want, 0, 1).astype(np.float64) * 65535 + 0.5)
    got = reference.pixels(tris, config, origins[step], axes[step], W, H, xs,
                           ys, 16).numpy()
    assert (np.abs(got - want).max(axis=1) > 16).sum() <= 1


def test_channel_values_read_both_depths():
    fmt8 = dict(width=2, height=1, pitch=6, bits=8)
    assert check.channel_values(bytes([1, 2, 3, 4, 5, 6]), fmt8,
                                np.array([1]), np.array([0])).tolist() == \
        [[4, 5, 6]]
    fmt16 = dict(width=1, height=1, pitch=6, bits=16)
    assert check.channel_values(bytes([1, 2, 0, 3, 255, 255]), fmt16,
                                np.array([0]), np.array([0])).tolist() == \
        [[258, 3, 65535]]


def test_lower_precision_reads_differently():
    _nt, _s, config, tris, (origins, axes) = scene_and_tris(
        "cell120.video1080")
    xs, ys = check.sample_pixels(7, 0, W, H, 256)
    hi = reference.pixels(tris, config, origins[20], axes[20], W, H, xs, ys, 8)
    lo = reference.pixels(tris, config, origins[20], axes[20], W, H, xs, ys, 8,
                          dtype=torch.bfloat16)
    assert (hi - lo).abs().max() > 1
