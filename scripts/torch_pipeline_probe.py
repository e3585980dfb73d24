#!/usr/bin/env python3
"""Where a CallbackRenderer frame of ntracer_tpu_torch spends its time on
one NVIDIA GPU: the flagship 120-cell (chip_smoke.py's) at 1024x1024.

    python3 scripts/torch_pipeline_probe.py [--frames 16] [--rounds 3]

1. Every call in one frame's dispatch (``wavefront.dispatch_packed``) that
   synchronizes with the device, named by torch's sync debug mode.
2. The dispatch's host time alone (the device drained before each), the
   device frame time (CUDA events) and one slab pull's host time.
3. The blocking loop and the pipelined loop (CallbackRenderer, three
   buffers) in turns, for each way the pull can wait for its copy: the
   copy stream with a spinning event (``spin``), the copy stream with a
   blocking-sync event (``blocking``), the copy stream polled with sleeps
   (``poll``), and the device's current stream (``cpu``: a plain
   ``.cpu()``, no copy stream); ``port`` is ``wavefront._to_host`` as it
   stands.  Frames per second, medians of ``--rounds`` rounds (each
   round's too), and begin_render's median return time.

Every frame's bytes are checked against the first blocking frame of the
same camera.  Prints the card's name and power limit first.
"""

import argparse
import math
import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402
from ntracer_tpu_torch import (NTracer, Material, ImageFormat, Channel,  # noqa: E402
                               BlockingRenderer, CallbackRenderer)
from ntracer_tpu_torch.engine import wavefront as wf  # noqa: E402

W = H = 1024


def _copy_stream_pull(make_event, wait):
    def to_host(data, ready):
        if not data.is_cuda:
            return data.numpy()
        stream = torch.cuda.Stream(data.device)
        host = torch.empty(data.shape, dtype=data.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            host.copy_(data, non_blocking=True)
            data.record_stream(stream)
            copied = make_event()
            copied.record(stream)
        wait(copied)
        return host.numpy()
    return to_host


def _poll(event):
    while not event.query():
        time.sleep(0.0002)


PULLS = {
    "port": wf._to_host,
    "spin": _copy_stream_pull(torch.cuda.Event, lambda e: e.synchronize()),
    "blocking": _copy_stream_pull(lambda: torch.cuda.Event(blocking=True),
                                  lambda e: e.synchronize()),
    "poll": _copy_stream_pull(torch.cuda.Event, _poll),
    "cpu": lambda data, ready: data.cpu().numpy(),
}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames", type=int, default=16)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--pulls", default=",".join(PULLS),
                        help="the pulls to compare, of " + ",".join(PULLS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    name_limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(name_limit, flush=True)
    dev = torch.device("cuda")
    nt = NTracer(4)
    dist = -4.0
    scene, _camera, _n = smoke.cell120_scene(nt, Material((1, 0.5, 0.5)),
                                             dist, lit=False)
    fmt = ImageFormat(W, H, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])
    blocking = BlockingRenderer()
    callback = CallbackRenderer()
    start = scene.get_camera()
    buf = bytearray(fmt.pitch * H)
    for _ in range(3):
        blocking.render(buf, fmt, scene)
    torch.cuda.synchronize()

    # 1. the syncs of one dispatch
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        slabs = wf.dispatch_packed(scene, fmt, dev)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [str(w.message).splitlines()[0] for w in caught]
    print(f"syncs in one dispatch: {len(syncs)}")
    for line in sorted(set(syncs)):
        print(f"   {syncs.count(line)} x {line}")

    # 2. the dispatch alone, the device frame, one slab's pull
    host_ms, dev_ms, pull_ms = [], [], []
    for _ in range(args.frames):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t1 = time.perf_counter()
        slabs = wf.dispatch_packed(scene, fmt, dev)
        host_ms.append(1000 * (time.perf_counter() - t1))
        b.record()
        torch.cuda.synchronize()
        dev_ms.append(a.elapsed_time(b))
        t1 = time.perf_counter()
        wf._to_host(slabs[0][1], slabs[0][2])
        pull_ms.append(1000 * (time.perf_counter() - t1))
    print(f"dispatch host {np.median(host_ms):.4f} ms, device frame "
          f"{np.median(dev_ms):.4f} ms (events around the dispatch), one "
          f"slab's pull {np.median(pull_ms):.4f} ms (medians of "
          f"{args.frames}) [{name_limit}]", flush=True)

    # reference bytes of the orbit
    incr = 2 * math.pi / args.frames
    scene.set_camera(start)
    camera = scene.get_camera()
    want = []
    for _ in range(args.frames):
        blocking.render(buf, fmt, scene)
        want.append(bytes(buf))
        smoke.turn(nt, scene, camera, dist, incr)

    def blocking_loop():
        scene.set_camera(start)
        cam = scene.get_camera()
        out = [bytearray(fmt.pitch * H) for _ in want]
        t1 = time.perf_counter()
        for b_ in out:
            blocking.render(b_, fmt, scene)
            smoke.turn(nt, scene, cam, dist, incr)
        s = time.perf_counter() - t1
        return s, [], out

    def pipelined_loop(depth=3):
        scene.set_camera(start)
        cam = scene.get_camera()
        out = [bytearray(fmt.pitch * H) for _ in want]
        slots = threading.Semaphore(depth)
        finished = threading.Event()
        count = [0]

        def cb(_r):
            count[0] += 1
            slots.release()
            if count[0] == len(out):
                finished.set()

        begin = []
        t1 = time.perf_counter()
        for b_ in out:
            slots.acquire()
            t2 = time.perf_counter()
            callback.begin_render(b_, fmt, scene, cb)
            begin.append(1000 * (time.perf_counter() - t2))
            smoke.turn(nt, scene, cam, dist, incr)
        if not finished.wait(timeout=300):
            raise SystemExit("the pipelined loop stalled")
        return time.perf_counter() - t1, begin, out

    pulls = args.pulls.split(",")
    results = {(p, loop): [] for p in pulls for loop in ("blocking",
                                                         "pipelined")}
    begins = {p: [] for p in pulls}
    real = wf._to_host
    try:
        for r in range(args.rounds):
            order = pulls if r % 2 == 0 else pulls[::-1]
            for p in order:
                wf._to_host = PULLS[p]
                for name, loop in (("blocking", blocking_loop),
                                   ("pipelined", pipelined_loop)):
                    s, begin, out = loop()
                    if [bytes(b_) for b_ in out] != want:
                        raise SystemExit(f"{p} {name}: bytes differ")
                    results[p, name].append(len(out) / s)
                    begins[p] += begin
    finally:
        wf._to_host = real
    for p in pulls:
        print(f"pull {p:9s}: blocking "
              f"{np.median(results[p, 'blocking']):.3f} frames/s (rounds "
              f"{[round(x, 3) for x in results[p, 'blocking']]}), pipelined "
              f"{np.median(results[p, 'pipelined']):.3f} frames/s (rounds "
              f"{[round(x, 3) for x in results[p, 'pipelined']]}), "
              f"begin_render {np.median(begins[p]):.4f} ms [{name_limit}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
