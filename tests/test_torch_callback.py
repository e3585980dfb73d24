"""The port's CallbackRenderer against the JAX package's contract
(tests/test_engine.py's CallbackRenderer tests): FIFO frames equal to the
blocking renderer's, abort with a queue, a worker that survives a failed
pull, a scene changed after the dispatch, abort_render from outside and
from inside a callback; and the frame's slabs, which are the JAX package's
and between which abort is polled."""

import threading
import time

import numpy as np
import pytest
import torch

import jax
from ntracer_tpu.engine import wavefront as jwf
from ntracer_tpu.render import BlockingRenderer as JaxRenderer
from ntracer_tpu_torch import BlockingRenderer, CallbackRenderer, NTracer
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import JAX, api, random_scene, rgb8

WAIT = 120


def _advance(nt, scene):
    c = scene.get_camera()
    c.transform(nt.Matrix.rotation(c.axes[0], c.axes[2], 0.3))
    c.normalize()
    scene.set_camera(c)


def test_callback_renderer_pipelined_queue():
    """Three frames in flight, the camera moved after each begin_render:
    each buffer holds the blocking renderer's frame for its camera, the
    callbacks come in FIFO order, and the first frame is within one code of
    the JAX package's."""
    nt = NTracer(3)
    scene = random_scene(3, n=40, seed=7)
    cam = scene.get_camera()
    fmt = rgb8(32, 32)

    blocking = []
    br = BlockingRenderer(device="cpu")
    for _ in range(3):
        buf = bytearray(fmt.pitch * fmt.height)
        assert br.render(buf, fmt, scene)
        blocking.append(bytes(buf))
        _advance(nt, scene)

    scene.set_camera(cam)
    cr = CallbackRenderer(device="cpu")
    bufs = [bytearray(fmt.pitch * fmt.height) for _ in range(3)]
    done = threading.Event()
    order = []

    def callback(k):
        def cb(r):
            assert r is cr
            order.append(k)
            if len(order) == 3:
                done.set()
        return cb

    for k in range(3):
        cr.begin_render(bufs[k], fmt, scene, callback(k))
        assert not scene.locked  # locked only for the dispatch
        _advance(nt, scene)
    assert done.wait(timeout=WAIT)
    assert order == [0, 1, 2]
    for k in range(3):
        assert bytes(bufs[k]) == blocking[k], f"frame {k} differs"
    cr.abort_render()  # nothing in flight: returns at once

    jscene = random_scene(3, n=40, seed=7, pkg=JAX)
    ref = bytearray(fmt.pitch * fmt.height)
    assert JaxRenderer().render(ref, api(JAX).ImageFormat(
        32, 32, [api(JAX).Channel(8, 1, 0, 0), api(JAX).Channel(8, 0, 1, 0),
                 api(JAX).Channel(8, 0, 0, 1)]), jscene)
    diff = np.abs(np.frombuffer(bufs[0], np.uint8).astype(int)
                  - np.frombuffer(bytes(ref), np.uint8).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99


def test_callback_renderer_abort_queue():
    """abort_render drops the queued frames without callbacks and waits for
    them; the renderer renders again afterwards."""
    scene = random_scene(3, n=30, seed=17)
    fmt = rgb8(24, 24)
    cr = CallbackRenderer(device="cpu")
    entered = threading.Event()
    release = threading.Event()
    calls = []

    def first(r):
        entered.set()
        release.wait(timeout=WAIT)
        calls.append(0)

    bufs = [bytearray(fmt.pitch * fmt.height) for _ in range(3)]
    cr.begin_render(bufs[0], fmt, scene, first)
    assert entered.wait(timeout=WAIT)  # the worker holds frame 0
    for k in (1, 2):
        cr.begin_render(bufs[k], fmt, scene, lambda r, k=k: calls.append(k))
    threading.Timer(0.2, release.set).start()
    cr.abort_render()  # the running frame's callback ends, the rest drop
    assert calls == [0] and cr._jobs == 0 and not cr._queue
    assert not any(bufs[1]) and not any(bufs[2])

    done = threading.Event()
    cr.begin_render(bufs[1], fmt, scene, lambda r: done.set())
    assert done.wait(timeout=WAIT)
    assert bytes(bufs[1]) == bytes(bufs[0]) and any(bufs[1])


def test_callback_renderer_survives_failed_pull(monkeypatch, capsys):
    """A pull that raises does not end the worker: it prints the traceback,
    the frame gets no callback, and the next frame renders."""
    scene = random_scene(3, n=30, seed=19)
    fmt = rgb8(24, 24)
    real_pull = pwf.pull_packed
    fail_once = [True]

    def flaky_pull(*a, **k):
        if fail_once[0]:
            fail_once[0] = False
            raise RuntimeError("injected link failure")
        return real_pull(*a, **k)

    monkeypatch.setattr(pwf, "pull_packed", flaky_pull)
    cr = CallbackRenderer(device="cpu")
    buf = bytearray(fmt.pitch * fmt.height)
    called = threading.Event()
    cr.begin_render(buf, fmt, scene, lambda r: called.set())
    cr.abort_render()  # waits for the failed job
    assert not called.is_set()
    assert "injected link failure" in capsys.readouterr().err

    done = threading.Event()
    cr.begin_render(buf, fmt, scene, lambda r: done.set())
    assert done.wait(timeout=WAIT)
    assert any(buf) and cr._worker.is_alive()


def test_callback_renderer_mutation_after_dispatch_uses_prior_state():
    """The scene is locked only for the dispatch, which captures its state:
    a change made right after begin_render returns is allowed and does not
    reach the frame in flight; the next frame has it."""
    scene = random_scene(3, n=40, seed=23)
    fmt = rgb8(24, 24)
    scene.set_ambient_color((0.05, 0.05, 0.05))
    expect = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer(device="cpu").render(expect, fmt, scene)

    cr = CallbackRenderer(device="cpu")
    buf = bytearray(fmt.pitch * fmt.height)
    done = threading.Event()
    cr.begin_render(buf, fmt, scene, lambda r: done.set())
    scene.set_ambient_color((0.9, 0.0, 0.0))
    assert done.wait(timeout=WAIT)
    assert bytes(buf) == bytes(expect)

    buf2 = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer(device="cpu").render(buf2, fmt, scene)
    assert bytes(buf2) != bytes(expect)


def test_abort_render_waits_for_callback_and_returns_inside_one():
    """abort_render returns only after a running callback has finished; from
    inside a callback it drops the queued frames and returns at once."""
    scene = random_scene(3, n=20, seed=29)
    fmt = rgb8(16, 16)
    cr = CallbackRenderer(device="cpu")
    buf = bytearray(fmt.pitch * fmt.height)
    entered = threading.Event()
    finished = []

    def slow_cb(r):
        entered.set()
        time.sleep(0.5)
        finished.append(True)

    cr.begin_render(buf, fmt, scene, slow_cb)
    assert entered.wait(timeout=WAIT)
    cr.abort_render()
    assert finished, "abort_render returned while the callback was running"

    queued = threading.Event()
    calls = []
    returned = threading.Event()

    def aborting(r):
        calls.append(0)
        queued.wait(timeout=WAIT)
        r.abort_render()  # inside the worker: must not wait for itself
        returned.set()

    bufs = [bytearray(fmt.pitch * fmt.height) for _ in range(3)]
    cr.begin_render(bufs[0], fmt, scene, aborting)
    for k in (1, 2):
        cr.begin_render(bufs[k], fmt, scene, lambda r, k=k: calls.append(k))
    queued.set()
    assert returned.wait(timeout=WAIT)
    cr.abort_render()
    assert calls == [0] and cr._jobs == 0 and not cr._queue


def test_callback_renderer_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CallbackRenderer()
    assert CallbackRenderer(device="cpu").device == torch.device("cpu")


def test_slabs_match_jax_and_abort_polls_between_them(monkeypatch):
    """A 512x512 BoxScene has 8 tiles of 32,768 rays and so 2 slabs, which
    start where the JAX package's single-device dispatch starts them; an
    abort after the first slab's pull returns False with only that slab's
    bytes written."""
    fmt = rgb8(512, 512)
    scenes = []
    for nt in (api(JAX).NTracer(4), NTracer(4)):
        scene = nt.BoxScene()
        cam = nt.Camera()
        cam.translate(nt.Vector.axis(2, -3))
        scene.set_camera(cam)
        scenes.append(scene)
    one = jax.devices()[:1]
    monkeypatch.setattr(jwf.jax, "devices", lambda *a: one)
    jfmt = api(JAX).ImageFormat(512, 512, [api(JAX).Channel(8, 1, 0, 0),
                                           api(JAX).Channel(8, 0, 1, 0),
                                           api(JAX).Channel(8, 0, 0, 1)])
    jslabs = jwf.dispatch_packed(scenes[0], jfmt)
    slabs = pwf.dispatch_packed(scenes[1], fmt, "cpu")
    assert [s for s, *_ in slabs] == [s for s, _ in jslabs] == [0, 131072]
    assert [len(dev) for _s, dev, _r in slabs] == [131072 // 4] * 2

    full = bytearray(fmt.pitch * fmt.height)
    assert pwf.pull_packed(slabs, fmt, memoryview(full), lambda: False)
    ref = bytearray(fmt.pitch * fmt.height)
    assert jwf.pull_packed(jslabs, jfmt, memoryview(ref), lambda: False)
    assert full == ref

    polls = []

    def abort_after_first():
        polls.append(1)
        return len(polls) > 1

    part = bytearray(fmt.pitch * fmt.height)
    assert not pwf.pull_packed(slabs, fmt, memoryview(part),
                               abort_after_first)
    half = 131072 * fmt.bytes_per_pixel
    assert part[:half] == full[:half] and not any(part[half:])
    assert len(polls) == 2
