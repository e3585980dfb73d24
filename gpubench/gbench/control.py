"""The control: the reference put in the program's place, computed a
precision below the configuration's (bfloat16 for float32).  It renders the
frames a run of the cell would keep for ``seed`` and is compared as the
program is (``check.compare``); ``correct`` has to come out false.

    python3 gpubench/gbench/control.py <cell> <seed> [<seed> ...]

prints, for each seed, the frames' off shares and the worst beside the
cell's limit.  It imports nothing of the program and needs no card (on the
CPU a full-size cell takes minutes).
"""

from __future__ import annotations

import os
import sys

import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

from gbench import check, orbit, reference, spec  # noqa: E402

LOWER = {"float32": torch.bfloat16}


def control_shares(name, seed, device, overrides=None, bench=None):
    """(per-frame off shares, gap counts, limit) of the control for the
    frames a run of cell ``name`` keeps for ``seed``."""
    overrides = overrides or {}
    bench = bench or spec.load_benchmark()
    sp = spec.resolve(bench, name)
    config = spec.merge(sp["config"], overrides.get("config"))
    traffic = spec.merge(sp["traffic"], overrides.get("traffic"))
    chk = spec.merge(spec.check_file(name), overrides.get("check"))
    builder = spec.load_module("scenes", config["builder"])
    d = builder.dimension(config)
    tris = spec.simplices(builder, config)
    origins, axes = orbit.cameras(d, builder.camera_distance(config),
                                  traffic["camera"])
    start = orbit.start_step(traffic["camera"], seed)
    w, h, bits = int(traffic["width"]), int(traffic["height"]), \
        int(traffic["bits"])
    fmt = dict(width=w, height=h, pitch=w * 3 * bits // 8, bits=bits)
    n = len(origins)
    frames = [(k, origins[(start + k) % n], axes[(start + k) % n], None)
              for k in check.kept_frames(seed, chk)]
    dtype = LOWER[config["precision"]]
    rows = reference.simplex_rows(tris, dtype, device)

    def lower(origin, ax, xs, ys):
        return reference.pixels(tris, config, origin, ax, w, h, xs, ys, bits,
                                dtype, device, rows=rows).cpu().numpy()

    shares, gaps = check.compare(frames, tris, config, fmt, seed,
                                 int(chk["pixels"]), int(chk["tolerance"]),
                                 device, reference_pixels=lower)
    return shares, gaps, float(chk["limit"])


def main():
    name, seeds = sys.argv[1], [int(s) for s in sys.argv[2:]]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in seeds:
        shares, gaps, limit = control_shares(name, seed, device)
        print(f"control {name} seed {seed}: worst_frame_off_share "
              f"{max(shares)} (limit {limit}); shares {shares}; gaps {gaps}",
              flush=True)


if __name__ == "__main__":
    main()
