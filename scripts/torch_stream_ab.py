#!/usr/bin/env python3
"""Time the streaming nearest-hit walks of ntracer_tpu_torch (kernels 2.5
and 2.7) from several CUDA source trees against each other on one card.

    python3 scripts/torch_stream_ab.py NAME=CSRC_DIR [NAME=CSRC_DIR ...]

Each CSRC_DIR holds nearest_hit.cu, nearest_hit_transparent.cu and the
headers they include: ntracer_tpu_torch/csrc of this tree, of another
commit unpacked with ``git archive``, or an edited copy.  Their C entries
``ntr_nearest_hit_hbm`` and ``ntr_nearest_t_hbm`` take this tree's
arguments.  The script compiles the two sources of every tree with this
tree's nvcc flags, builds chip_smoke.py's mesh and glass mesh (the
495,612-triangle sphere of scripts/bench_mesh.py, opaque, and glass and
opaque by turns, K = 8) and their primary wavefronts at 1024x1024 (shared
rows, front-to-back order), checks that every tree gives the first tree's
outputs bit for bit, and times each kernel in turns (A, B, ..., B, A; three
launches a turn).  It prints, for each tree, ptxas's registers and spills
of the d = 3 kernels and, for each wavefront, the mean time in ms with the
card's name and power limit.  Needs one CUDA card; the port never imports
it.
"""

import ctypes
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ntracer_tpu_torch import NTracer, Material  # noqa: E402
from ntracer_tpu_torch.engine import _build  # noqa: E402
from ntracer_tpu_torch.engine import resident_kernels as rk  # noqa: E402
from ntracer_tpu_torch.engine import wavefront as wf  # noqa: E402

SOURCES = ("nearest_hit.cu", "nearest_hit_transparent.cu")


def build(trees, out):
    """One shared library a tree (both sources compiled side by side);
    returns {name: (library, ptxas report)}."""
    nvcc = _build.find_nvcc()
    procs = {}
    for name, csrc in trees:
        for src in SOURCES:
            obj = os.path.join(out, f"{name}.{src}.o")
            procs[name, src] = (obj, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-c", "-o", obj,
                 os.path.join(csrc, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for (name, src), (obj, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}/{src}:\n{text}")
        logs[name] = logs.get(name, "") + text
    libs = {}
    for name, _csrc in trees:
        so = os.path.join(out, f"{name}.so")
        subprocess.run([nvcc, "-shared", "-o", so] +
                       [procs[name, s][0] for s in SOURCES], check=True)
        lib = ctypes.CDLL(so)
        lib.ntr_nearest_hit_hbm.argtypes = _build._NEAREST_ARGS
        lib.ntr_nearest_t_hbm.argtypes = _build._NEAREST_T_ARGS
        lib.ntr_error_string.argtypes = [ctypes.c_int]
        lib.ntr_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, logs[name])
    return libs


def ptxas_d3(log):
    """(kernel, registers, spill stores, spill loads) of every d = 3 entry
    function in a ptxas -v report."""
    rows = []
    for m in re.finditer(
            r"Compiling entry function '\w*?\d(nearest_\w*?kernel)I"
            r"(Li3E\w*?)EEEv.*?(\d+) bytes spill stores, (\d+) bytes spill "
            r"loads.*?Used (\d+) registers", log, re.S):
        rows.append((f"{m.group(1)}<{m.group(2)}>", int(m.group(5)),
                     int(m.group(3)), int(m.group(4))))
    return rows


def wavefronts(dev):
    """The mesh and the glass mesh primary wavefronts as walk inputs."""
    nt3 = NTracer(3)
    tris = cs.sphere_mesh(cs.MESH_TRIS)
    solid, glass = Material((0.3, 0.8, 0.5)), \
        Material((1, 0.7, 0.7), opacity=0.4)
    groups = wf._frame_groups(-(-(cs.W * cs.H) // wf.TILE))
    xs, ys, _unswz = wf._frame_coords(groups, cs.W, dev)
    cases = {}
    for label, mats, K in (
            ("mesh primary", [solid] * len(tris), 0),
            ("glass mesh primary",
             [glass if i % 2 else solid for i in range(len(tris))], 8)):
        scene, _cam = cs.mesh_scene(
            nt3, nt3.TrianglePrototype.batch_from_points(tris, mats))
        cfg, arrs, _flat = wf.get_device_scene(scene, dev)
        cam_o = torch.as_tensor(scene._cam._origin, device=dev)
        cam_t = torch.as_tensor(scene._cam._t, device=dev)
        oT, dT = wf.make_rays(cam_o, cam_t,
                              *wf._fov_params(cs.W, cs.H, scene.fov), xs, ys)
        pctx = wf.primary_ctx(arrs, cfg, cam_o)
        res = wf._res_dict(arrs)
        if K:
            res["opa"] = arrs["res_opa"]
        skip = torch.full((dT.shape[1],), -1, dtype=torch.int32, device=dev)
        cases[label] = rk._walk_inputs(res, oT, dT, skip, 3, pctx["order"],
                                       None, pctx["sh_res"], K=K)
    return cases


def main():
    trees = [a.split("=", 1) for a in sys.argv[1:]]
    if not trees or any(len(t) != 2 for t in trees):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("torch finds no CUDA device")
    card = cs.card()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as out:
        libs = build(trees, out)
        for name, (_lib, log) in libs.items():
            for row in ptxas_d3(log):
                print(f"{name}: {row[0]}: {row[1]} registers, spill stores "
                      f"{row[2]} B, loads {row[3]} B")
        cases = wavefronts(dev)
        names = [n for n, _c in trees]

        def run(name, w):
            _build._lib = libs[name][0]
            entry = "ntr_nearest_t_hbm" if w["K"] else "ntr_nearest_hit_hbm"
            err, got = rk._nearest_kernel(entry, w, w["oT"].device)
            if err:
                raise SystemExit(f"{name}: {entry} failed ({err})")
            return got

        for label, w in cases.items():
            ref = run(names[0], w)
            for name in names[1:]:
                for a, b in zip(run(name, w), ref):
                    if a.dtype == torch.float32:
                        a, b = a.view(torch.int32), b.view(torch.int32)
                    if not torch.equal(a, b):
                        raise SystemExit(f"{name} differs from {names[0]} "
                                         f"on the {label}")
            times = {n: [] for n in names}
            for name in names + names[::-1]:
                times[name].append(cs.time_cuda(lambda: run(name, w), 3))
            for name in names:
                print(f"{label}: {name} {np.mean(times[name]):.4f} ms "
                      f"(turns {', '.join(f'{t:.4f}' for t in times[name])})"
                      f" [{card}]")


if __name__ == "__main__":
    main()
