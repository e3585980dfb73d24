#!/usr/bin/env python3
"""Time hand-written walks of ntracer_tpu_torch from several CUDA source
trees against each other on one card.

    python3 scripts/torch_stream_ab.py [--kernels 2.1,2.2,2.3,2.4,2.5,...] \
        [--reps 3] [--rounds 1] NAME=CSRC_DIR [NAME=CSRC_DIR ...]

Each CSRC_DIR holds the sources of the chosen kernels and the headers they
include: ntracer_tpu_torch/csrc of this tree, of another commit unpacked
with ``git archive``, or an edited copy.  The kernels and their wavefronts,
each at 1024x1024 (1,048,576 rays):

  * 2.1, ``ntr_nearest_hit`` (nearest_hit.cu): chip_smoke.py's wavefronts
    of its "nearest_hit kernel vs twin" phase -- the flagship 120-cell's
    primary rays (shared rows, front-to-back order) and its bounce rays
    (every other block active), the lit configuration's primary rays
    (d = 6) -- and the entry pass alone on the flagship pool (every block
    live, no chunk within any ray's start distance: no visit);
  * 2.2, ``ntr_occluded`` (occluded.cu): shadow rays from the primary hits
    of the lit 120-cell (chip_smoke.py's "lit 120-cell" path; its point
    light is the "flagship point light" of the "occluded kernel vs twin"
    phase: most blocks live) and of ``lit_config`` (d = 6, 348 rays hit:
    nearly dead), to the point light and along the global light, and the
    ``lit_config`` wavefront with every ray inactive;
  * 2.3, ``ntr_nearest_t`` (nearest_hit_transparent.cu): chip_smoke.py's
    wavefronts of its "nearest_hit_transparent kernel vs twin" phase --
    the glass 120-cell's primary rays (shared rows, front-to-back order)
    and bounce rays (every other block active), the "transparent d=3"
    scene's primary rays -- with K = 8;
  * 2.4, ``ntr_occluded_t`` (occluded_transparent.cu): chip_smoke.py's
    shadow wavefronts of the glass 120-cell and of the "transparent d=3"
    scene, towards the point light and along the global light;
  * 2.5, ``ntr_nearest_hit_hbm`` (nearest_hit.cu): the primary wavefront of
    chip_smoke.py's mesh (the 495,612-triangle sphere of
    scripts/bench_mesh.py), shared rows, front-to-back order;
  * 2.7, ``ntr_nearest_t_hbm`` (nearest_hit_transparent.cu): the same of
    the glass mesh (glass and opaque by turns, K = 8);
  * 2.9, ``ntr_grid_nearest_hit`` (grid_walk.cu): chip_smoke.py's
    wavefronts of the 10-orthoplex (primary, shared rows, and bounce), of
    the 9-orthoplex (primary) and of a 16-D pool (aimed from the camera);
  * 2.10, ``ntr_grid_occluded`` (grid_walk.cu): chip_smoke.py's shadow
    wavefronts of its "grid occluded kernel vs twin" phase -- the
    10-orthoplex's to the point light, along the global light and from a
    light at the camera, the 9-orthoplex's and the 16-D pool's along the
    global light -- and the 10-orthoplex's with every ray inactive.

Every entry takes this tree's arguments, but for 2.9 (2.10) a tree whose
library has no ``ntr_grid_nearest_hit_info`` (``ntr_grid_occluded_info``)
reads the pool's plane rows ``gt`` (d*d, T) where this tree's kernel reads
the plane records (``grid_kernels.plane_records``).  The script compiles
the chosen sources of every tree with this tree's nvcc flags (the
wavefronts are made with this tree's own library), checks that every tree
gives the first tree's outputs bit for bit, and times each kernel in turns
(A, B, ..., B, A, ``--rounds`` times; ``--reps`` launches a turn, three by
default: more for the short launches), on the card (CUDA events) and on
the host (three calls back to back, no synchronisation between them: a
launch that waits for an earlier one shows the kernel's time there).  It
prints, for each tree, ptxas's registers and spills of the kernels at d =
3 (2.3, 2.5, 2.7), 4 (2.1, 2.2, 2.3, 2.4), 6 (2.2), 10 and 16 (2.9, 2.10)
and, for each wavefront, the mean times in ms with the card's name and
power limit.
Needs one CUDA card; the port never imports it.
"""

import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ntracer_tpu_torch import NTracer, Material  # noqa: E402
from ntracer_tpu_torch import kdtree  # noqa: E402
from ntracer_tpu_torch.engine import _build  # noqa: E402
from ntracer_tpu_torch.engine import grid_kernels as gk  # noqa: E402
from ntracer_tpu_torch.engine import resident_kernels as rk  # noqa: E402
from ntracer_tpu_torch.engine import wavefront as wf  # noqa: E402

# kernel -> (source, C entry, its ctypes arguments, ptxas kernel pattern)
KERNELS = {
    "2.1": ("nearest_hit.cu", "ntr_nearest_hit", _build._NEAREST_ARGS,
            r"nearest_\w*kernelILi4E"),
    "2.2": ("occluded.cu", "ntr_occluded", _build._OCCLUDED_ARGS,
            r"occluded_(stream_)?kernelILi[46]E"),
    "2.3": ("nearest_hit_transparent.cu", "ntr_nearest_t",
            _build._NEAREST_T_ARGS, r"nearest_t_(stream_)?kernelILi[34]E"),
    "2.4": ("occluded_transparent.cu", "ntr_occluded_t",
            _build._OCCLUDED_T_ARGS, r"occluded_t\w*kernelILi4E"),
    "2.5": ("nearest_hit.cu", "ntr_nearest_hit_hbm", _build._NEAREST_ARGS,
            r"nearest_\w*kernelILi3E"),
    "2.7": ("nearest_hit_transparent.cu", "ntr_nearest_t_hbm",
            _build._NEAREST_T_ARGS, r"nearest_t\w*kernelILi3E"),
    "2.9": ("grid_walk.cu", "ntr_grid_nearest_hit",
            _build._GRID_NEAREST_ARGS, r"grid_nearest_kernelILi1[06]E"),
    "2.10": ("grid_walk.cu", "ntr_grid_occluded", _build._GRID_OCCLUDED_ARGS,
             r"grid_occluded_kernel(ILi1[06]E|EPK)"),
}


def build(trees, kernels, out):
    """One shared library a tree (its sources compiled side by side);
    returns {name: (library, ptxas report)}."""
    nvcc = _build.find_nvcc()
    # nearest_hit.cu also holds ntr_error_string
    sources = sorted({KERNELS[k][0] for k in kernels} | {"nearest_hit.cu"})
    procs = {}
    for name, csrc in trees:
        for src in sources:
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
                       [procs[name, s][0] for s in sources], check=True)
        lib = ctypes.CDLL(so)
        for k in kernels:
            fn = getattr(lib, KERNELS[k][1])
            fn.argtypes = KERNELS[k][2]
            fn.restype = ctypes.c_int
        lib.ntr_error_string.argtypes = [ctypes.c_int]
        lib.ntr_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, logs[name])
    return libs


def ptxas_rows(log, kernels):
    """(kernel, registers, spill stores, spill loads) of the chosen kernels'
    entry functions (at the d named in KERNELS) in a ptxas -v report."""
    rows = []
    for m in re.finditer(
            r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
            r"(\d+) bytes spill loads.*?Used (\d+) registers", log, re.S):
        if any(re.search(KERNELS[k][3], m.group(1)) for k in kernels):
            rows.append((m.group(1), int(m.group(4)), int(m.group(2)),
                         int(m.group(3))))
    return rows


def mesh_cases(dev, kernels):
    """The mesh and the glass mesh primary wavefronts as walk inputs."""
    nt3 = NTracer(3)
    tris = cs.sphere_mesh(cs.MESH_TRIS)
    solid, glass = Material((0.3, 0.8, 0.5)), \
        Material((1, 0.7, 0.7), opacity=0.4)
    groups = wf._frame_groups(-(-(cs.W * cs.H) // wf.TILE))
    xs, ys, _unswz = wf._frame_coords(groups, cs.W, dev)
    cases = {}
    for kernel, label, mats, K in (
            ("2.5", "mesh primary", [solid] * len(tris), 0),
            ("2.7", "glass mesh primary",
             [glass if i % 2 else solid for i in range(len(tris))], 8)):
        if kernel not in kernels:
            continue
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
        cases[label] = (kernel, rk._walk_inputs(
            res, oT, dT, skip, 3, pctx["order"], None, pctx["sh_res"], K=K))
    return cases


def primary_hits(scene, dev):
    """A scene's primary wavefront at 1024x1024 and its hits (this tree's
    library): (cfg, arrs, cam_o, oT, dT, pctx, hit)."""
    groups = wf._frame_groups(-(-(cs.W * cs.H) // wf.TILE))
    xs, ys, _unswz = wf._frame_coords(groups, cs.W, dev)
    cfg, arrs, _flat = wf.get_device_scene(scene, dev)
    cam_o = torch.as_tensor(scene._cam._origin, device=dev)
    cam_t = torch.as_tensor(scene._cam._t, device=dev)
    oT, dT = wf.make_rays(cam_o, cam_t,
                          *wf._fov_params(cs.W, cs.H, scene.fov), xs, ys)
    pctx = wf.primary_ctx(arrs, cfg, cam_o)
    skip = torch.full((dT.shape[1],), -1, dtype=torch.int32, device=dev)
    hit = wf.trace_pool(arrs, cfg, oT, dT, skip, shared_origin=cam_o,
                        pctx=pctx)
    return cfg, arrs, cam_o, oT, dT, pctx, hit


def nearest_cases(dev):
    """Kernel 2.1's inputs, chip_smoke.py's: the flagship's primary
    wavefront (shared rows, front-to-back order) and bounce wavefront
    (reflections off the primary hits, every other block active, each ray
    skipping the surface it leaves), the lit configuration's primary
    wavefront, and the entry-pass probe on the flagship pool."""
    flagship, _cam, _n = cs.cell120_scene(NTracer(4), Material((1, 0.5, 0.5)),
                                          -4.0, lit=False)
    lit, _cam = cs.lit_scene(NTracer(6), Material)
    cases = {}
    for label, scene in (("flagship", flagship), ("lit", lit)):
        cfg, arrs, _o, oT, dT, pctx, hit = primary_hits(scene, dev)
        res = wf._res_dict(arrs)
        skip = torch.full((dT.shape[1],), -1, dtype=torch.int32, device=dev)
        cases[f"{label} primary"] = ("2.1", rk._walk_inputs(
            res, oT, dT, skip, cfg.d, pctx["order"], None, pctx["sh_res"]))
        if label != "flagship":
            continue
        R = dT.shape[1]
        sine = -wf._dotT(dT, hit["normalT"])
        blk = torch.arange(R, device=dev) // rk.RAY_BLOCK
        cases["flagship bounce"] = ("2.1", rk._walk_inputs(
            res, hit["pointT"], wf._unitT(dT - hit["normalT"] *
                                          (-2 * sine)[None, :]),
            hit["pid"], cfg.d, None, hit["hit"] & (blk % 2 == 0), None))
        # every origin far outside the pool's box, pointing away, and a
        # start distance no chunk is within: the entry pass and no visit
        far = torch.full((cfg.d, R), 10.0, device=dev)
        out = torch.full((cfg.d, R), cfg.d ** -0.5, device=dev)
        pw = rk._walk_inputs(res, far, out, skip, cfg.d, None, None, None)
        pw["init_t"] = torch.full((R,), 1e-30, device=dev)
        pw["blive"] = torch.ones_like(pw["blive"])
        cases["flagship entry pass"] = ("2.1", pw)
    return cases


def grid_shadow_cases(dev):
    """Kernel 2.10's inputs, chip_smoke.py's: shadow rays from the primary
    hits of the 10-orthoplex (to its point light, along its global light,
    from a light at the camera, and with every ray inactive), of the
    9-orthoplex and of rays from the camera aimed at a 16-D pool of 200
    random simplices (along the global light)."""
    opaque = Material((1, 0.5, 0.5))
    orth, _cam, _n = cs.orthoplex_scene(NTracer(10), opaque)
    cfg, arrs, cam_o, _oT, dT, _p, hit = primary_hits(orth, dev)
    orth9, _cam, _n = cs.orthoplex_scene(NTracer(9), opaque)
    cfg9, arrs9, _o, _oT, _dT, _p, hit9 = primary_hits(orth9, dev)
    pool16, simplices = cs.random_pool(NTracer(16),
                                       Material((0.8, 0.5, 0.9)), 200)
    cfg16, arrs16, _flat = wf.get_device_scene(pool16, dev)
    cam16 = torch.as_tensor(pool16._cam._origin, device=dev)
    oT16 = cam16[:, None].expand(16, dT.shape[1]).contiguous()
    dT16 = torch.as_tensor(cs.aimed(pool16._cam._origin, simplices,
                                    dT.shape[1]), device=dev)
    skip = torch.full((dT.shape[1],), -1, dtype=torch.int32, device=dev)
    hit16 = wf.trace_pool(arrs16, cfg16, oT16, dT16, skip,
                          shared_origin=cam16,
                          pctx=wf.primary_ctx(arrs16, cfg16, cam16))
    kern = wf._kern_dict(arrs)
    cases = {}
    for label, (kern_, d, hit_, light) in {
            "orthoplex point light": (kern, 10, hit,
                                      dict(light_pos=arrs["pl_pos"][0])),
            "orthoplex global light": (kern, 10, hit,
                                       dict(light_dir=arrs["gl_dir"][0])),
            "orthoplex camera light": (kern, 10, hit, dict(light_pos=cam_o)),
            "orthoplex9 global light": (wf._kern_dict(arrs9), 9, hit9,
                                        dict(light_dir=arrs9["gl_dir"][0])),
            "random16 global light": (wf._kern_dict(arrs16), 16, hit16,
                                      dict(light_dir=arrs16["gl_dir"][0])),
            "orthoplex dead": (kern, 10, hit,
                               dict(light_dir=arrs["gl_dir"][0])),
    }.items():
        point, dirs, ldist = cs.grid_shadow_rays(hit_, **light)
        if label.endswith("dead"):
            ldist = torch.zeros_like(ldist)
        w = gk._grid_inputs(kern_, point, dirs, hit_["pid"], d, ldist=ldist)
        cases[label] = ("2.10", w)
    return cases


def light_rays(arrs, hit, light_pos=None, light_dir=None):
    """Shadow rays from the hit points ``hit`` to a point light or along a
    global light, as chip_smoke.py makes them: (point, dirs, ldist), the
    misses inactive."""
    point = torch.where(hit["hit"][None, :], hit["pointT"], 0.0)
    if light_pos is not None:
        lv = point - light_pos[:, None]
        dist = rk._sqrt(wf._dotT(lv, lv))
        return point, (lv / dist[None, :]).contiguous(), \
            torch.where(hit["hit"], dist, 0.0)
    gl = (-light_dir)[:, None].expand_as(point).contiguous()
    exit_t = rk._scene_exit_T(point, gl, arrs["res_blo"], arrs["res_bhi"])
    return point, gl, torch.where(hit["hit"], exit_t, 0.0)


def occlusion_cases(dev):
    """Kernel 2.2's inputs: shadow rays from the primary hits of the lit
    120-cell and of ``lit_config``, to the first point light and along the
    global light (each ray skipping the surface it lies on), and
    ``lit_config``'s with every ray inactive."""
    lit120, _cam, _n = cs.cell120_scene(NTracer(4), Material((1, 0.5, 0.5)),
                                        -4.0, lit=True)
    lit, _cam = cs.lit_scene(NTracer(6), Material)
    cases = {}
    for label, scene in (("lit 120-cell", lit120), ("lit_config", lit)):
        cfg, arrs, _o, _oT, _dT, _p, hit = primary_hits(scene, dev)
        res = wf._res_dict(arrs)
        for light, kw in (("point light", dict(light_pos=arrs["pl_pos"][0])),
                          ("global light", dict(light_dir=arrs["gl_dir"][0]))):
            point, dirs, ldist = light_rays(arrs, hit, **kw)
            cases[f"{label} {light}"] = ("2.2", rk._occlusion_inputs(
                res, point, dirs, ldist, hit["pid"], cfg.d, None))
    cases["lit_config dead"] = ("2.2", rk._occlusion_inputs(
        res, point, dirs, torch.zeros_like(ldist), hit["pid"], cfg.d, None))
    return cases


def transparent_cases(dev):
    """Kernel 2.3's inputs, chip_smoke.py's: the glass 120-cell's primary
    wavefront (shared rows, front-to-back order) and bounce wavefront
    (reflections off the primary hits, every other block active, each ray
    skipping the surface it leaves), and the "transparent d=3" scene's
    primary wavefront, K = 8."""
    solid, glass_m = Material((0.3, 0.8, 0.5)), \
        Material((1, 0.7, 0.7), opacity=0.4)
    glass, _cam, _n = cs.cell120_scene(
        NTracer(4), lambda i: glass_m if i % 2 else solid, -4.0, lit=True)
    with cs.unbatched(kdtree):
        d3 = cs.mesh_d3_scene(NTracer(3), Material((0.7, 0.8, 1.0),
                                                   opacity=0.45), 500)
    cases = {}
    for label, scene in (("glass", glass), ("d3", d3)):
        cfg, arrs, _o, oT, dT, pctx, hit = primary_hits(scene, dev)
        K = cfg.max_transparent_hits
        res = wf._res_dict(arrs)
        res["opa"] = arrs["res_opa"]
        skip = torch.full((dT.shape[1],), -1, dtype=torch.int32, device=dev)
        cases[f"{label} primary"] = ("2.3", rk._walk_inputs(
            res, oT, dT, skip, cfg.d, pctx["order"], None, pctx["sh_res"],
            K=K))
        if label != "glass":
            continue
        sine = -wf._dotT(dT, hit["normalT"])
        blk = torch.arange(dT.shape[1], device=dev) // rk.RAY_BLOCK
        cases["glass bounce"] = ("2.3", rk._walk_inputs(
            res, hit["pointT"], wf._unitT(dT - hit["normalT"] *
                                          (-2 * sine)[None, :]),
            hit["pid"], cfg.d, None, hit["hit"] & (blk % 2 == 0), None, K=K))
    return cases


def shadow_cases(dev):
    """Kernel 2.4's inputs: chip_smoke.py's shadow wavefronts of the glass
    120-cell (from the opaque hits) and of the "transparent d=3" scene
    (from the first glass surface), to the point light and along the
    global light."""
    nt = NTracer(4)
    solid, glass_m = Material((0.3, 0.8, 0.5)), \
        Material((1, 0.7, 0.7), opacity=0.4)
    glass, _cam, _n = cs.cell120_scene(
        nt, lambda i: glass_m if i % 2 else solid, -4.0, lit=True)
    with cs.unbatched(kdtree):
        d3 = cs.mesh_d3_scene(NTracer(3), Material((0.7, 0.8, 1.0),
                                                   opacity=0.45), 500)
    cases = {}
    for label, scene in (("glass", glass), ("d3", d3)):
        cfg, arrs, _o, oT, dT, _p, hit = primary_hits(scene, dev)
        if label == "d3":
            first = hit["tidT"][0] >= 0
            hit = dict(hit=first, pid=torch.where(first, hit["tidT"][0], -1),
                       pointT=oT + hit["ttT"][0][None, :] * dT)
        res = wf._res_dict(arrs)
        point = torch.where(hit["hit"][None, :], hit["pointT"], 0.0)
        lv = point - arrs["pl_pos"][0][:, None]
        dist = rk._sqrt(wf._dotT(lv, lv))
        gl = (-arrs["gl_dir"][0])[:, None].expand_as(point).contiguous()
        exit_t = rk._scene_exit_T(point, gl, arrs["res_blo"],
                                  arrs["res_bhi"])
        for light, dirs, ldist in (
                ("point light", (lv / dist[None, :]).contiguous(),
                 torch.where(hit["hit"], dist, 0.0)),
                ("global light", gl, torch.where(hit["hit"], exit_t, 0.0))):
            cases[f"{label} {light}"] = ("2.4", rk._occlusion_inputs(
                res, point, dirs, ldist, hit["pid"], cfg.d, None,
                filtered=True))
    return cases


def grid_cases(dev):
    """Kernel 2.9's inputs, chip_smoke.py's: the 10-orthoplex's primary
    wavefront (shared rows) and its bounce wavefront (every ray, each
    skipping the surface it leaves), the 9-orthoplex's primary wavefront
    and rays from the camera aimed at a 16-D pool of 200 random
    simplices (shared rows)."""
    opaque = Material((1, 0.5, 0.5))
    orth, _cam, _n = cs.orthoplex_scene(NTracer(10), opaque)
    cfg, arrs, _o, oT, dT, pctx, hit = primary_hits(orth, dev)
    kern = wf._kern_dict(arrs)
    skip = torch.full((dT.shape[1],), -1, dtype=torch.int32, device=dev)
    sine = -wf._dotT(dT, hit["normalT"])
    b_dT = wf._unitT(dT - hit["normalT"] * (-2 * sine)[None, :])
    orth9, _cam, _n = cs.orthoplex_scene(NTracer(9), opaque)
    cfg9, arrs9, _o, oT9, dT9, pctx9, _hit = primary_hits(orth9, dev)
    pool16, simplices = cs.random_pool(NTracer(16),
                                       Material((0.8, 0.5, 0.9)), 200)
    cfg16, arrs16, _flat = wf.get_device_scene(pool16, dev)
    cam16 = torch.as_tensor(pool16._cam._origin, device=dev)
    oT16 = cam16[:, None].expand(16, dT.shape[1]).contiguous()
    dT16 = torch.as_tensor(cs.aimed(pool16._cam._origin, simplices,
                                    dT.shape[1]), device=dev)
    pctx16 = wf.primary_ctx(arrs16, cfg16, cam16)
    return {
        "orthoplex primary": ("2.9", gk._grid_inputs(
            kern, oT, dT, skip, cfg.d, sh=pctx["sh_kern"])),
        "orthoplex bounce": ("2.9", gk._grid_inputs(
            kern, hit["pointT"], b_dT, hit["pid"], cfg.d)),
        "orthoplex9 primary": ("2.9", gk._grid_inputs(
            wf._kern_dict(arrs9), oT9, dT9, skip, cfg9.d,
            sh=pctx9["sh_kern"])),
        "random16 aimed": ("2.9", gk._grid_inputs(
            wf._kern_dict(arrs16), oT16, dT16, skip, 16,
            sh=pctx16["sh_kern"])),
    }


def grid_call(lib, w, records):
    """2.9 from ``lib``: (t, id, tiles).  ``records()`` gives the pool's
    plane records, read by a library with ``ntr_grid_nearest_hit_info``."""
    dev = w["oT"].device
    R, T = gk._check_grid(w, dev)
    out_t = torch.empty((R,), dtype=torch.float32, device=dev)
    out_id = torch.empty((R,), dtype=torch.int32, device=dev)
    tiles = torch.empty((R // gk.RAY_BLOCK,), dtype=torch.int32, device=dev)
    rows = records() if hasattr(lib, "ntr_grid_nearest_hit_info") \
        else w["gt"]
    init_t = w["init_t"].contiguous()
    err = lib.ntr_grid_nearest_hit(
        w["oT"].data_ptr(), w["dT"].data_ptr(), w["skip"].data_ptr(),
        init_t.data_ptr(), rows.data_ptr(), w["ci"].data_ptr(),
        w["k_lo"].data_ptr(), w["k_hi"].data_ptr(), w["k_any"].data_ptr(),
        T, R, w["d"], int(w["shared"]), out_t.data_ptr(), out_id.data_ptr(),
        tiles.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return err, (out_t, out_id, tiles)


def grid_occluded_call(lib, w, records):
    """2.10 from ``lib``: (blocked, tiles).  ``records()`` gives the pool's
    plane records, read by a library with ``ntr_grid_occluded_info``."""
    dev = w["oT"].device
    R, T = gk._check_grid(w, dev)
    blocked = torch.empty((R,), dtype=torch.bool, device=dev)
    tiles = torch.empty((R // gk.RAY_BLOCK,), dtype=torch.int32, device=dev)
    rows = records() if hasattr(lib, "ntr_grid_occluded_info") else w["gt"]
    err = lib.ntr_grid_occluded(
        w["oT"].data_ptr(), w["dT"].data_ptr(), w["skip"].data_ptr(),
        w["ldist"].data_ptr(), rows.data_ptr(), w["ci"].data_ptr(),
        w["k_lo"].data_ptr(), w["k_hi"].data_ptr(), w["k_any"].data_ptr(),
        T, R, w["d"], blocked.data_ptr(), tiles.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    return err, (blocked, tiles)


def host_ms(fn, reps):
    """Host time of one call of ``fn`` in ``reps`` calls made back to back
    with no synchronisation between them, in ms: a launch that waits for
    the device shows its kernel's time here, one that only enqueues shows
    the wrapper's and the driver's."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def main():
    args = sys.argv[1:]
    opts = {"--kernels": ",".join(KERNELS), "--reps": "3", "--rounds": "1"}
    while args and args[0].split("=", 1)[0] in opts:
        spec = args.pop(0).split("=", 1)
        opts[spec[0]] = spec[1] if len(spec) == 2 else args.pop(0)
    kernels = opts["--kernels"].split(",")
    reps, rounds = int(opts["--reps"]), int(opts["--rounds"])
    trees = [a.split("=", 1) for a in args]
    if not trees or any(len(t) != 2 for t in trees) or \
            any(k not in KERNELS for k in kernels):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("torch finds no CUDA device")
    card = cs.card()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as out:
        libs = build(trees, kernels, out)
        for name, (_lib, log) in libs.items():
            for row in ptxas_rows(log, kernels):
                print(f"{name}: {row[0]}: {row[1]} registers, spill stores "
                      f"{row[2]} B, loads {row[3]} B")
        # the wavefronts, with this tree's library
        cases = {}
        if "2.1" in kernels:
            cases.update(nearest_cases(dev))
        if "2.2" in kernels:
            cases.update(occlusion_cases(dev))
        if "2.3" in kernels:
            cases.update(transparent_cases(dev))
        if "2.4" in kernels:
            cases.update(shadow_cases(dev))
        cases.update(mesh_cases(dev, kernels))
        if "2.9" in kernels:
            cases.update(grid_cases(dev))
        if "2.10" in kernels:
            cases.update(grid_shadow_cases(dev))
        records = {}
        names = [n for n, _c in trees]

        def run(name, kernel, w):
            lib = libs[name][0]
            _build._lib = lib
            def plane_records():
                key = id(w["gt"])
                if key not in records:
                    records[key] = gk.plane_records(w["gt"], w["d"])
                return records[key]

            if kernel == "2.9":
                err, got = grid_call(lib, w, plane_records)
            elif kernel == "2.10":
                err, got = grid_occluded_call(lib, w, plane_records)
            elif kernel in ("2.2", "2.4"):
                err, got = rk._occlusion_kernel(KERNELS[kernel][1], w,
                                                w["oT"].device)
            else:
                err, got = rk._nearest_kernel(KERNELS[kernel][1], w,
                                              w["oT"].device)
            if err:
                raise SystemExit(f"{name}: {KERNELS[kernel][1]} failed "
                                 f"({err})")
            return got

        for label, (kernel, w) in cases.items():
            ref = run(names[0], kernel, w)
            for name in names[1:]:
                for a, b in zip(run(name, kernel, w), ref):
                    if a.dtype == torch.float32:
                        a, b = a.view(torch.int32), b.view(torch.int32)
                    if not torch.equal(a, b):
                        raise SystemExit(f"{name} differs from {names[0]} "
                                         f"on the {label}")
            times = {n: [] for n in names}
            host = {n: [] for n in names}
            for name in (names + names[::-1]) * rounds:
                times[name].append(cs.time_cuda(
                    lambda: run(name, kernel, w), reps))
                host[name].append(host_ms(lambda: run(name, kernel, w), 3))
            for name in names:
                print(f"{kernel} {label}: {name} "
                      f"{np.mean(times[name]):.4f} ms (turns "
                      f"{', '.join(f'{t:.4f}' for t in times[name])}), "
                      f"host {np.mean(host[name]):.4f} ms a launch"
                      f" [{card}]")
            print(f"{kernel} {label}: outputs equal bit for bit across "
                  f"{', '.join(names)}")


if __name__ == "__main__":
    main()
