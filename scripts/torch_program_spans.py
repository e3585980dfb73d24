#!/usr/bin/env python3
"""What the port's own spans and counters say in a gpubench cell, and what
recording them costs, on one card.

    python3 scripts/torch_program_spans.py --workload CELL --seed N \
        [--program 0|1] [--traffic MIX] [--seconds 20]
    python3 scripts/torch_program_spans.py --workload CELL --interleave N

The first form runs the cell once as the benchmark's traced run does
(``run_cell`` with ``--trace 1``), with the port's tracing on
(``--program 1``, through ``gpubench/gbench/program.py``) or off, and
``--traffic`` in place of the cell's mix (``view1024``: the viewer's
CallbackRenderer loop).  It prints one JSON line: the harness's per-layer
metrics and, with the port's tracing on, the metrics its records give
(glue, walk launch, pull wait and write a frame, chunk visits a frame,
idle share in the glue, the set-up's spans), the grid walks' tiles a window
frame (``grid_tiles_visited``, ``occl_grid_tiles_visited``: mean, least
and most), the kinds of walk the window's ``dispatch.walk`` spans name
(their ``walk`` attribute), the window's frames that
replayed and captured their glue's CUDA graphs, the host milliseconds a
window frame in each program span, the traced frames' idle seconds by the
innermost program span, whether each traced walk kernel starts inside its
spans on the mapped clock and, for a callback mix, the slow frames' time
by span against all frames' (``viewer``).  Run each in a process of its
own: once torch.profiler has run in a process, later frames there
dispatch slower.

The second form renders N frames of the cell's camera path in one process,
the port's tracing on for every other frame, and prints the host
milliseconds of ``dispatch_packed`` and ``pull_packed`` a frame with it on
and off (medians, and the median of the differences between neighbouring
frames): the cost of recording.

Each JSON line carries the card's name and power limit.  Needs one CUDA
card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# as gpubench/run.py: few numeric-library threads, set before numpy loads
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "gpubench"))
sys.path.insert(1, REPO)

from gbench import cell, loops, orbit, program, spec  # noqa: E402


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()


# the grid walk counters of frame_stats (kernels 2.9 and 2.10)
GRID_COUNTERS = ("grid_tiles_visited", "occl_grid_tiles_visited")


def suffix(name):
    for family in ("mesh", "orth"):
        if name.startswith(family):
            return family
    return "video"


def walk_kernel(name):
    """The walk kernel a cell's primary walk launches."""
    return "grid_nearest_kernel" if suffix(name) == "orth" \
        else "nearest_stream_kernel"


def grid_tiles(counters, frames):
    """Mean, least and most of each grid walk counter over ``frames``
    (every frame counts: 0 where the counter is absent); None for a counter
    no frame has."""
    out = {}
    for k in GRID_COUNTERS:
        got = [counters.get(f, {}).get(k, 0) for f in frames]
        if any(k in counters.get(f, {}) for f in frames):
            out[k] = dict(mean=statistics.mean(got), least=min(got),
                          most=max(got))
        else:
            out[k] = None
    return out


def viewer(run):
    """The window's frames by span: the mean host ms of each program span
    over all frames and over the slow ones (the tenth with the longest
    interval from the callback before theirs to their own)."""
    frames = set(program.window_frames(run))
    cb = sorted((s["start"], s["frame"]) for s in program.spans(
        run, "frame.callback") if s["frame"] in frames)
    gaps = sorted(((b[0] - a[0], b[1]) for a, b in zip(cb, cb[1:])),
                  reverse=True)
    slow = [f for _g, f in gaps[:max(1, len(gaps) // 10)]]
    names = sorted({s["name"] for s in program.spans(run)
                    if s["frame"] in frames})
    return dict(
        frames=len(frames), slow=len(slow),
        interval_ms=dict(median=1e-6 * statistics.median(
            g for g, _f in gaps), slow_least=1e-6 * gaps[len(slow) - 1][0]),
        all={n: program.ms_per_frame(run, (n,), sorted(frames))
             for n in names},
        slow_frames={n: program.ms_per_frame(run, (n,), slow)
                     for n in names})


def one_run(name, seed, seconds, on, device="cuda:0", overrides=None):
    """One traced run of cell ``name``; returns its record."""
    result, _lines, notes, run = program.run_cell(
        name, seed, seconds, True, program=on, device=device,
        overrides=overrides)
    rec = dict(cell=name, seed=seed, program=on, correct=result["correct"],
               attempted=result["attempted"], metrics={
                   k: v["value"] for k, v in result["metrics"].items()},
               device=result["device"], check={
                   k: v["value"] for k, v in result["check"].items()},
               notes=notes)
    if not on:
        return rec
    frames = program.window_frames(run)
    names = sorted({s["name"] for s in program.spans(run)})
    counters = run["program"]["counters"]
    rec.update(
        window_frames=len(frames),
        # frames of the window that replayed or captured their glue's
        # CUDA graphs (ntracer_tpu_torch/engine/graphs.py)
        graph_frames={k: sum(counters.get(f, {}).get(k, 0) for f in frames)
                      for k in ("glue_graph_replays", "glue_graph_captures")},
        # frames of the window whose post-walk glue ran as one kernel
        # (wavefront.shade_pack)
        glue_fused_frames=sum(counters.get(f, {}).get("glue_fused", 0)
                              for f in frames),
        grid_tiles=grid_tiles(counters, frames),
        walk_kinds=sorted({str(s["attrs"].get("walk")) for s in
                           program.spans(run, "dispatch.walk")
                           if s["frame"] in set(frames)}),
        program=program.read(run, suffix(name)),
        span_ms={n: program.ms_per_frame(run, (n,), frames) for n in names},
        setup_spans_s={n: program.setup_s(run, n) for n in names})
    if run["traced"] and run["traced"]["ops"]:
        rec["alignment"] = program.alignment(run, walk_kernel(name))
        rec["idle_by_span"] = program.idle_by_span(run)
    if run["traffic"]["renderer"] == "callback":
        rec["viewer"] = viewer(run)
    return rec


class _Alternating(loops.Loop):
    """A renderer loop whose frames turn the port's tracing on and off in
    turns (on for odd frames)."""

    def step(self, k):
        from ntracer_tpu_torch import tracing
        (tracing.enable if k % 2 else tracing.disable)()
        super().step(k)


def interleave(name, frames, device="cuda:0"):
    """``frames`` frames of cell ``name``'s camera path, the port's tracing
    on for every other one; the host ms a frame of the dispatch and the
    pull, on and off."""
    from ntracer_tpu_torch import NTracer, tracing
    from ntracer_tpu_torch.engine import wavefront

    sp = spec.resolve(spec.load_benchmark(), name)
    config, traffic = sp["config"], sp["traffic"]
    builder = spec.load_module("scenes", config["builder"])
    d = builder.dimension(config)
    nt = NTracer(d)
    scene = cell.build_scene(config, builder, nt,
                             spec.simplices(builder, config), {}, device)
    origins, axes = orbit.cameras(d, builder.camera_distance(config),
                                  traffic["camera"])
    fmt, _ = cell.image_format(traffic)
    spans = loops.Spans(on=True)
    spans.wrap(wavefront, "dispatch_packed", "dispatch")
    spans.wrap(wavefront, "pull_packed", "pull")
    try:
        loop = _Alternating(dict(traffic, renderer="blocking"), scene,
                            cell.camera_objects(nt, origins, axes), 0, fmt,
                            device, spans)
        loop.run(-4, count=4)
        spans.spans = {}
        loop.run(0, count=frames)
    finally:
        spans.unwrap()
        tracing.disable()
        tracing.drain()
    out = dict(cell=name, interleave=frames)
    for what in ("dispatch", "pull"):
        ms = [1e3 * (b - a) for a, b in spans.spans[what]]
        on, off = ms[1::2], ms[0::2]
        diff = [b - a for a, b in zip(off, on)]
        out[what] = dict(on=statistics.median(on), off=statistics.median(off),
                         paired=statistics.median(diff))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2147483693)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    ap.add_argument("--traffic")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--interleave", type=int)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    import torch
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    if args.interleave:
        rec = interleave(args.workload, args.interleave)
    else:
        over = None
        if args.traffic:
            over = {"traffic": spec.read_json(os.path.join(
                spec.BENCH_DIR, "traffic", args.traffic + ".json"))}
        rec = one_run(args.workload, args.seed, args.seconds,
                      bool(args.program), overrides=over)
        rec["traffic"] = args.traffic
    rec.update(card=card(), s=time.perf_counter() - t0)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
