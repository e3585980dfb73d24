"""The mixes' camera loops: the same for the same seed, and the cameras of
scripts/polytope.py's advance_camera step for step, in its own plane and in
the plane of scripts/hypercube.py's turn."""

import math
import os

import numpy as np
import pytest

from gbench import orbit, spec

POLYTOPE = {"steps_per_turn": 160, "from": [2], "to": "others"}


def test_same_seed_same_loop():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cam = spec.resolve(bench, w["name"])["traffic"]["camera"]
        seed = 2**31 + 97
        assert orbit.start_step(cam, seed) == orbit.start_step(cam, seed)
        a = orbit.cameras(4, -4.0, cam)
        b = orbit.cameras(4, -4.0, cam)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    starts = {orbit.start_step(POLYTOPE, s) for s in range(40)}
    assert len(starts) > 20


def test_one_turn_is_periodic_and_orthonormal():
    origins, axes = orbit.cameras(4, -4.0, POLYTOPE)
    assert origins.shape == (160, 4) and axes.shape == (160, 4, 4)
    for ax, o in zip(axes, origins):
        np.testing.assert_allclose(ax @ ax.T, np.eye(4), atol=1e-6)
        np.testing.assert_allclose(o, ax[2] * -4.0, atol=1e-6)
    np.testing.assert_array_equal(axes[0], np.eye(4, dtype=np.float32))


def polytope_advance(nt, camera, cam_distance, incr):
    """scripts/polytope.py's advance_camera, on the port's API."""
    hcoef = 1 / math.sqrt(nt.dimension - 1)
    a2 = camera.axes[0] * hcoef + camera.axes[1] * hcoef
    for i in range(nt.dimension - 3):
        a2 = a2 + camera.axes[i + 3] * hcoef
    camera.transform(nt.Matrix.rotation(camera.axes[2], a2, incr))
    camera.normalize()
    camera.origin = camera.axes[2] * cam_distance


@pytest.mark.parametrize("d", [3, 4, 5])
def test_polytope_loop_step_for_step(d):
    from ntracer_tpu_torch import NTracer
    nt = NTracer(d)
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, -4.0))
    origins, axes = orbit.cameras(d, -4.0, POLYTOPE)
    for k in range(12):
        np.testing.assert_allclose(np.asarray(list(camera.origin)),
                                   origins[k], atol=5e-6)
        for i in range(d):
            np.testing.assert_allclose(np.asarray(list(camera.axes[i])),
                                       axes[k][i], atol=5e-6)
        polytope_advance(nt, camera, -4.0, 2 * math.pi / 160)


def test_mesh_orbit_step_for_step():
    """The mesh's orbit: hypercube.py's turn, Matrix.rotation(axis 2,
    axis 0, 2 pi / 60), with the origin put back on the view axis after
    each step as polytope.py's advance_camera puts it (hypercube.py's own
    loop leaves the origin where it is and turns in place)."""
    from ntracer_tpu_torch import NTracer
    nt = NTracer(3)
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, -4.0))
    spec_ = spec.read_json(os.path.join(spec.BENCH_DIR, "traffic",
                                        "orbit1024.json"))["camera"]
    origins, axes = orbit.cameras(3, -4.0, spec_)
    for k in range(12):
        for i in range(3):
            np.testing.assert_allclose(np.asarray(list(camera.axes[i])),
                                       axes[k][i], atol=5e-6)
        np.testing.assert_allclose(np.asarray(list(camera.origin)),
                                   origins[k], atol=5e-6)
        camera.transform(nt.Matrix.rotation(nt.Vector.axis(2),
                                            nt.Vector.axis(0),
                                            2 * math.pi / 60))
        camera.normalize()
        camera.origin = camera.axes[2] * -4.0
