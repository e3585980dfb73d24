"""One run of one cell: set-up, the measured window, the traced frames, the
reading of the metrics and the check that decides ``correct``."""

from __future__ import annotations

import gc
import math
import resource
import sys

import numpy as np

from . import check, orbit, spec, trace
from .loops import Loop, Spans, clock

# Top-level module names that must not be loaded in the process that
# prints the result: JAX and the JAX package this program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "ntracer_tpu", "ntracer")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def image_format(traffic):
    from ntracer_tpu_torch import Channel, ImageFormat
    bits = int(traffic["bits"])
    fmt = ImageFormat(int(traffic["width"]), int(traffic["height"]),
                      [Channel(bits, 1, 0, 0), Channel(bits, 0, 1, 0),
                       Channel(bits, 0, 0, 1)])
    return fmt, dict(width=fmt.width, height=fmt.height, pitch=fmt.pitch,
                     bits=bits)


def build_scene(config, builder, nt, tris, spans, device):
    """The scene as the user path builds it, with the set-up's host spans:
    prototypes (or the OBJ load), the k-d scene, the first device scene."""
    import torch
    from ntracer_tpu_torch.engine import wavefront

    t0 = clock()
    protos = builder.prototypes(config, nt, tris, spec.CACHE_DIR)
    t1 = clock()
    scene = nt.build_composite_scene(protos)
    t2 = clock()
    scene.set_fov(float(config["fov"]))
    bg = config["background"]
    scene.set_background(tuple(bg["bg1"]), tuple(bg["bg2"]), tuple(bg["bg3"]),
                         int(bg["axis"]))
    scene.set_ambient_color(tuple(config["ambient"]))
    scene.set_camera_light(bool(config["camera_light"]))
    wavefront.get_device_scene(scene, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t3 = clock()
    spans.update(prototypes=t1 - t0, kd_build=t2 - t1, device_scene=t3 - t2)
    return scene


def camera_objects(nt, origins, axes):
    cams = []
    for o, ax in zip(origins, axes):
        cam = nt.Camera()
        cam.origin = nt.Vector(*o.tolist())
        for i in range(len(ax)):
            cam.axes[i] = nt.Vector(*ax[i].tolist())
        cams.append(cam)
    return cams


def run_cell(name, seed, seconds, trace_on, t_start, device="cuda:0",
             bench=None, overrides=None, fault=None, marks=None):
    """Run cell ``name`` once.  Returns (result dict, {number compared:
    (value, limit)}, notes for standard error).  ``overrides`` ({"config":
    {...}, "traffic": {...}, "check": {...}}) shrink a cell for the CPU
    tests; ``fault(wavefront)`` breaks the timed path underneath for the
    tests that show ``correct`` can fail; ``marks`` collects the seconds
    from ``t_start`` at which each step of the set-up ended."""
    spans = Spans(on=bool(trace_on))
    try:
        return _run(name, seed, seconds, t_start, device,
                    bench or spec.load_benchmark(), overrides or {}, fault,
                    spans, {} if marks is None else marks)
    finally:
        spans.unwrap()


def _run(name, seed, seconds, t_start, device, bench, overrides, fault,
         spans, marks):
    import torch

    trace_on = spans.on
    sp = spec.resolve(bench, name)
    config = spec.merge(sp["config"], overrides.get("config"))
    traffic = spec.merge(sp["traffic"], overrides.get("traffic"))
    chk = spec.merge(spec.check_file(name), overrides.get("check"))
    cuda = torch.device(device).type == "cuda"
    builder = spec.load_module("scenes", config["builder"])

    import ntracer_tpu_torch as ntt
    from ntracer_tpu_torch.engine import wavefront

    marks["imports"] = clock() - t_start
    d = builder.dimension(config)
    nt = ntt.NTracer(d)
    setup = {}
    t0 = clock()
    tris = spec.simplices(builder, config)
    setup["geometry"] = clock() - t0
    marks["geometry"] = clock() - t_start
    scene = build_scene(config, builder, nt, tris, setup, device)
    marks["scene"] = clock() - t_start
    origins, axes = orbit.cameras(d, builder.camera_distance(config),
                                  traffic["camera"])
    cams = camera_objects(nt, origins, axes)
    start = orbit.start_step(traffic["camera"], seed)
    fmt, fmt_d = image_format(traffic)

    if trace_on:
        spans.wrap(wavefront, "dispatch_packed", "dispatch")
        spans.wrap(wavefront, "pull_packed", "pull")
    if fault is not None:
        fault(wavefront)
    loop = Loop(traffic, scene, cams, start, fmt, device, spans)

    marks["cameras"] = clock() - t_start
    warm = int(traffic["warmup_frames"])
    loop.run(-warm, count=1)
    marks["first frame"] = clock() - t_start
    loop.run(1 - warm, count=warm - 1)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    keep = check.kept_frames(seed, chk)

    t_w0 = clock()
    setup_s = t_w0 - t_start
    recs = loop.run(0, deadline=t_w0 + seconds, keep=keep)
    t_w1 = t_w0 + seconds
    window_spans = dict(spans.spans)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    finals = loop.buffers()
    kept = dict(loop.kept)

    traced = None
    if trace_on:
        spans.spans = {}
        n_tr = int(traffic["trace_frames"])
        first = recs[-1][0] + 1 if recs else 0
        ops, win_s, offset = trace.profile(
            lambda: loop.run(first, count=n_tr), cuda)
        traced = dict(ops=ops, window_s=win_s, offset=offset, frames=n_tr,
                      first=first, spans=dict(spans.spans))

    notes = []
    run = dict(cell=sp["cell"], config=config, traffic=traffic, fmt=fmt_d,
               seconds=seconds, t_w0=t_w0, t_w1=t_w1, records=recs,
               spans=window_spans, setup=setup, setup_s=setup_s,
               traced=traced, tris=tris, origins=origins, axes=axes,
               start=start, notes=notes)
    metrics = {}
    for m in (sp["per_layer"] if trace_on else sp["end_to_end"]):
        value = spec.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the program's state goes before the reference runs on the device
    frames = [(k, origins[(start + k) % len(cams)], axes[(start + k) % len(cams)],
               buf) for k, buf in sorted({**kept, **dict(finals)}.items())]
    failed = loop.failed
    attempted = len(recs)
    del loop, scene, cams, kept, finals
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_c = clock()
    shares, gaps = check.compare(frames, tris, config, fmt_d, seed,
                                int(chk["pixels"]), int(chk["tolerance"]),
                                device)
    worst = max(shares) if shares else math.inf
    found = forbidden_modules()
    lines = {
        "worst_frame_off_share": (worst, float(chk["limit"])),
        "frames_compared": (len(shares), 1),
        "frames_failed": (failed, 0),
        "jax_modules": (len(found), 0),
    }
    correct = (worst <= float(chk["limit"]) and len(shares) >= 1
               and failed == 0 and not found)
    result = dict(correct=bool(correct), attempted=attempted, failed=failed,
                  metrics=metrics)
    if cuda:
        result["device"] = dict(platform="gpu",
                                kind=torch.cuda.get_device_name(0),
                                count=1, memory_peak_bytes=int(memory_peak))
    else:
        result["device"] = dict(platform="cpu", kind="cpu", count=1,
                                memory_peak_bytes=0)
    if traced is not None:
        busy = sum(e - s for s, e in trace.busy(traced["ops"]))
        result["device"].update(busy_s=busy, window_s=traced["window_s"])
        result["breakdown"] = dict(
            device_ops=[[n, s] for n, s in trace.by_name(traced["ops"])[:10]],
            idle_gaps=[[n, s] for n, s in trace.idle_by_host(
                traced["ops"], traced["window_s"], traced["spans"],
                traced["offset"])[:10]])
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in lines.items()}
    notes += [f"set-up s {setup_s:.3f}: " + ", ".join(
                 f"{k} {v:.3f}" for k, v in setup.items())
              + "; ended at s: " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in marks.items()),
             f"check s {clock() - t_c:.3f}; compared pixels by largest "
             f"channel gap {gaps} (tolerance {chk['tolerance']}); off shares "
             f"of the frames compared {shares}"]
    ends = [r[2] - t_w0 for r in recs if r[2] is not None]
    notes.append("frames done in each fifth of the window: " + str(
        np.histogram(ends, bins=np.linspace(0, seconds, 6))[0].tolist()))
    notes.append(f"host peak RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} kB"
                 + (f", device peak after the window "
                    f"{torch.cuda.max_memory_allocated()} B" if cuda else ""))
    if found:
        notes.append(f"loaded in this process: {', '.join(found)}")
    return result, lines, notes
