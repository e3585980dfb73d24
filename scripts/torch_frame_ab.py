#!/usr/bin/env python3
"""Time whole frames of ntracer_tpu_torch from several checkouts against
each other on one card, in turns.

    python3 scripts/torch_frame_ab.py [--paths flagship,lit,...] \
        [--frames 8] [--rounds 2] NAME=CHECKOUT [NAME=CHECKOUT ...]

Each CHECKOUT is the root of a tree of this repository (this one, or
another commit unpacked with ``git archive``): its own ntracer_tpu_torch,
built into its own build/ directory on first use, and its chip_smoke.py,
whose scenes and camera orbit the frames use.  The paths are
chip_smoke.py's, at 1024x1024, 8-bit RGB, through ``BlockingRenderer()``:
"flagship", "lit", "lit 120-cell", "glass 120-cell" and "orthoplex d=10".
Each round runs every checkout once, in a process of its own, in the
order A, B, ... and then B, A, ...; a run renders a warm-up frame and
``--frames`` frames of each path's orbit (host clock around ``render()``,
pull included).  The script prints each run's median and, for each
checkout, the median over all its frames, with the card's name and power
limit.  Needs one CUDA card; the port never imports it.
"""

import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

PATHS = ("flagship", "lit", "lit 120-cell", "glass 120-cell",
         "orthoplex d=10")

# One run in a checkout: argv = checkout, paths, frames; prints
# {path: [ms, ...]}.
RUN = r"""
import json, sys
tree, paths, frames = sys.argv[1], sys.argv[2].split(","), int(sys.argv[3])
sys.path.insert(0, tree)
import chip_smoke as cs
from ntracer_tpu_torch import (NTracer, Material, ImageFormat, Channel,
                               BlockingRenderer)
fmt = ImageFormat(cs.W, cs.H, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                               Channel(8, 0, 0, 1)])
buf = bytearray(fmt.pitch * fmt.height)
renderer = BlockingRenderer()
opaque = Material((1, 0.5, 0.5))
solid, glass = Material((0.3, 0.8, 0.5)), Material((1, 0.7, 0.7),
                                                   opacity=0.4)
out = {}
for path in paths:
    dist = -4.0
    if path == "lit":
        nt = NTracer(6)
        scene, camera = cs.lit_scene(nt, Material)
        dist = -8.0
    elif path == "orthoplex d=10":
        nt = NTracer(10)
        scene, camera, _n = cs.orthoplex_scene(nt, opaque)
    else:
        nt = NTracer(4)
        material = {"glass 120-cell": lambda i: glass if i % 2 else solid}
        scene, camera, _n = cs.cell120_scene(
            nt, material.get(path, opaque), dist, lit=path != "flagship")
    out[path] = [1000 * s for s in cs.orbit(nt, scene, camera, dist, frames,
                                            renderer, buf, fmt)]
print(json.dumps(out))
"""


def run(tree, paths, frames):
    """One run in checkout ``tree``: {path: [frame ms, ...]}."""
    proc = subprocess.run(
        [sys.executable, "-c", RUN, os.path.abspath(tree), ",".join(paths),
         str(frames)], cwd=tree, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise SystemExit(f"the run in {tree} failed:\n{proc.stdout}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    args = sys.argv[1:]
    opts = {"--paths": ",".join(PATHS), "--frames": "8", "--rounds": "2"}
    while args and args[0] in opts:
        opts[args[0]] = args[1]
        args = args[2:]
    paths = opts["--paths"].split(",")
    trees = [a.split("=", 1) for a in args]
    if not trees or any(len(t) != 2 for t in trees) or \
            any(p not in PATHS for p in paths):
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch finds no CUDA device")
    card = cs.card()
    frames = {name: {p: [] for p in paths} for name, _t in trees}
    for r in range(int(opts["--rounds"])):
        for name, tree in (trees if r % 2 == 0 else trees[::-1]):
            got = run(tree, paths, int(opts["--frames"]))
            for p in paths:
                frames[name][p] += got[p]
                print(f"round {r + 1} {name} {p}: median "
                      f"{statistics.median(got[p]):.3f} ms over "
                      f"{len(got[p])} frames [{card}]", flush=True)
    for p in paths:
        for name, _t in trees:
            ms = frames[name][p]
            print(f"{p}: {name} median {statistics.median(ms):.3f} ms, min "
                  f"{min(ms):.3f}, max {max(ms):.3f} over {len(ms)} frames "
                  f"[{card}]")


if __name__ == "__main__":
    main()
