#!/usr/bin/env python3
"""Smoke run of ntracer_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ntracer_tpu_torch/csrc, holds each kernel
against its plain PyTorch twin on the card at the main paths' shapes, then
drives the main paths as a user does, through ``BlockingRenderer().render``
at 1024x1024, 8-bit RGB:

  * the flagship: bench.py's 4-D 120-cell {5,3,3}, an 8-frame camera orbit
    (one nearest-hit walk a frame);
  * the lit configuration: scripts/bench_suite.py's 6-D scene of 900 random
    simplices with two point lights, one global light and shadows on, a
    4-frame orbit (one nearest-hit walk and three occlusion walks a frame);

and checks 64 pixels of each frame against the scalar NumPy oracle.  Each
kernel's launch count is set to 0 before a path is driven and read after
it.  Any failed phase exits non-zero.  The last two lines of output are one
JSON object with every kernel's numbers and ``{"ok": true, "device":
{...}}``.

Exits non-zero without a result when torch finds no CUDA device.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
W = H = 1024
FRAMES = 8                 # flagship orbit
LIT_FRAMES = 4             # lit orbit
ORACLE_PIXELS = 64
ORACLE_TOL = 5e-5          # tests/test_pallas.py:356
ORACLE_MAX_OVER = 2

# The card's published peaks (NVIDIA H100 SXM data sheet): float32 outside
# the tensor cores, and device memory.
PEAK_FP32 = 67e12          # FLOP/s
PEAK_BYTES = 3.35e12       # bytes/s


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   ({time.perf_counter() - t0:.2f} s)", flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def polytope_vertices(symbol):
    """Vertices of a regular polytope: the orbit of the initial vertex under
    its Coxeter mirror group (the construction of scripts/polytope.py)."""
    n = len(symbol) + 1
    gram = np.eye(n)
    for i, p in enumerate(symbol):
        gram[i, i + 1] = gram[i + 1, i] = -math.cos(math.pi / float(p))
    normals = np.zeros((n, n))
    for i in range(n):
        for j in range(i):
            normals[i, j] = (gram[i, j] - normals[i, :j] @ normals[j, :j]) \
                / normals[j, j]
        normals[i, i] = math.sqrt(1.0 - normals[i, :i] @ normals[i, :i])
    v0 = np.linalg.svd(normals[1:])[2][-1]
    v0 = v0 / np.linalg.norm(v0)
    verts, seen, queue = [v0], {tuple(np.round(v0, 6))}, [v0]
    while queue:
        v = queue.pop()
        for m in normals:
            r = v - 2.0 * (v @ m) * m
            key = tuple(np.round(r, 6))
            if key not in seen:
                seen.add(key)
                verts.append(r)
                queue.append(r)
    return np.asarray(verts)


def hull_prototypes(nt, verts, material):
    """Boundary (d-1)-simplices of the hull, zero-volume slivers dropped
    (scripts/polytope.py hull_prototypes)."""
    from scipy.spatial import ConvexHull
    keep = []
    for simplex in ConvexHull(verts).simplices:
        pts = verts[simplex]
        edges = pts[1:] - pts[0]
        vol2 = np.linalg.det(edges @ edges.T)
        scale = np.prod(np.linalg.norm(edges, axis=1)) or 1.0
        if np.isfinite(vol2) and abs(vol2) >= (1e-6 * scale) ** 2:
            keep.append(pts)
    return nt.TrianglePrototype.batch_from_points(
        np.asarray(keep, dtype=np.float32), material)


def lit_scene(nt, Material, n=900, seed=3, cam_distance=-8.0):
    """The lit configuration (the construction of scripts/bench_suite.py
    ``lit_config``): ``n`` random simplices, two point lights, one global
    light, shadows on, camera on axis 2.  Returns (scene, camera)."""
    d = nt.dimension
    mat = Material((0.9, 0.6, 0.3))
    rng = np.random.RandomState(seed)
    protos = []
    for _ in range(n):
        base = rng.uniform(-2, 2, d)
        pts = [nt.Vector(*(base + rng.uniform(-0.7, 0.7, d)))
               for _ in range(d)]
        protos.append(nt.TrianglePrototype(pts, mat))
    scene = nt.build_composite_scene(protos)
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, cam_distance))
    scene.set_camera(camera)
    scene.add_light(nt.PointLight(nt.Vector.axis(1, 5), (1, 0.9, 0.7)))
    scene.add_light(nt.PointLight(nt.Vector.axis(0, -5), (0.4, 0.5, 0.9)))
    scene.add_light(nt.GlobalLight(nt.Vector.axis(1, -1), (0.2, 0.2, 0.3)))
    scene.set_shadows(True)
    return scene, camera


def time_cuda(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def walk_bound(d, shared, need, read, visits, chunks, pool_bytes,
               mask_bytes, out_bytes, early=None):
    """The least time (ms) the card could take for one walk on this run's
    data, and which bound it is: the larger of bytes over the memory rate
    and operations over the float32 rate.

    ``need`` (R,) bool marks the rays that can still be decided by a pair
    test (active, and for the nearest-hit walk inside the pool's box);
    ``read`` (R,) bool the rays whose origin and direction the function
    must look at to know that; ``visits`` (R/512,) is the run's chunk
    visits per block; ``early`` (R,) bool marks needed rays that one pair
    test decides (a shadow ray that ends blocked: its first hit ends its
    walk), which count one test each.

    Bytes: origin, direction and skip id of every 512-ray block that has a
    ray to read, ``mask_bytes`` per ray of the whole wavefront (the mask or
    distance that says which rays are active), the pool's rows and boxes
    once, every output once.  Operations, with multiply and add counted
    apart (the kernels contract no FMA): the slab entries of the needed
    rays into every chunk box (4 per axis), and the pair tests of the
    needed rays of each block in that block's visits (a decided ray needs
    none), x 128 slots: d*d multiply-adds per plane-dot set (two sets when
    the origin dots are not shared), the division, and 3 (shared: 2) + 1
    per edge plane."""
    rays = need.numel()
    full = need if early is None else need & ~early
    need_blk = full.reshape(-1, 512).sum(dim=1)
    read_blocks = int(read.reshape(-1, 512).any(dim=1).sum())
    in_bytes = read_blocks * 512 * (2 * d * 4 + 4) + rays * mask_bytes \
        + pool_bytes
    bytes_ms = 1e3 * (in_bytes + out_bytes) / PEAK_BYTES
    pair_ops = (2 * d * d + 1 + 3 * (d - 1)) if shared \
        else (4 * d * d + 2 + 4 * (d - 1))
    pairs = int((need_blk * visits.long()).sum()) * 128
    if early is not None:
        pairs += int((need & early).sum())
    ops = pairs * pair_ops + int(need.sum()) * chunks * 4 * d
    ops_ms = 1e3 * ops / PEAK_FP32
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms \
        else (ops_ms, "operations")


def pool_bytes(arrs):
    return sum(arrs[k].numel() * 4 for k in
               ("res_gt", "res_ci", "res_ids", "res_klo", "res_khi",
                "res_order"))


def orbit(nt, scene, camera, cam_distance, frames, renderer, buf, fmt):
    """Render a warm-up frame and ``frames`` frames of a camera orbit (the
    rotation of scripts/bench_suite.py); returns the frames' seconds."""
    incr = 2 * math.pi / frames
    d = nt.dimension
    hcoef = 1 / math.sqrt(d - 1)

    def advance():
        a2 = camera.axes[0] * hcoef + camera.axes[1] * hcoef
        for i in range(3, d):
            a2 = a2 + camera.axes[i] * hcoef
        camera.transform(nt.Matrix.rotation(camera.axes[2], a2, incr))
        camera.normalize()
        camera.origin = camera.axes[2] * cam_distance
        scene.set_camera(camera)

    if not renderer.render(buf, fmt, scene):       # warm-up
        raise SystemExit("warm-up render was aborted")
    advance()
    frame_s = []
    for _ in range(frames):
        t1 = time.perf_counter()
        if not renderer.render(buf, fmt, scene):
            raise SystemExit("render was aborted")
        frame_s.append(time.perf_counter() - t1)
        advance()
    return frame_s


def report_frames(label, frame_s, buf, name_limit):
    px = np.frombuffer(bytes(buf), np.uint8).reshape(H, W, 3)
    print(f"   last frame: {int((px.max(axis=2) > 0).sum())} lit pixels, "
          f"mean byte {px.mean():.3f}")
    if px.max() == 0:
        raise SystemExit(f"the {label} frame is black")
    ms = 1000 * float(np.median(frame_s))
    print(f"   {label} frame: median {ms:.3f} ms/frame, "
          f"{W * H / (ms / 1000) / 1e6:.3f} Mrays/s, min "
          f"{1000 * min(frame_s):.3f} max {1000 * max(frame_s):.3f} ms over "
          f"{len(frame_s)} orbit frames (host clock around render(), pull "
          f"included) [{name_limit}]")


def oracle_check(scene, colors, pixels):
    """Hold ``colors`` (H, W, 3) against the scalar oracle at ``pixels``."""
    if colors.shape != (H, W, 3) or not np.isfinite(colors).all():
        raise SystemExit(f"bad frame colors: shape {colors.shape}")
    scene._set_view_size(W, H)
    over = []
    worst = 0.0
    for x, y in pixels:
        ref = scene._pixel_color(x, y)
        diff = float(np.abs(ref - colors[y, x]).max())
        worst = max(worst, diff)
        if diff > ORACLE_TOL:
            over.append((x, y, diff))
            print(f"   pixel ({x}, {y}): port {colors[y, x]}, oracle {ref}, "
                  f"diff {diff}")
    print(f"   {len(pixels)} pixels, worst diff {worst}, "
          f"{len(over)} beyond {ORACLE_TOL}")
    if len(over) > ORACLE_MAX_OVER:
        raise SystemExit("the frame disagrees with the oracle")


def main():
    t0 = phase("device")
    if not torch.cuda.is_available():
        print("torch finds no CUDA device", file=sys.stderr)
        return 1
    name_limit = card()
    kind = torch.cuda.get_device_name(0)
    print(name_limit)
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): {kind}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    done(t0)

    sys.path.insert(0, REPO)
    import ntracer_tpu_torch as nt_torch
    from ntracer_tpu_torch import NTracer, Material, ImageFormat, Channel
    from ntracer_tpu_torch import kdnodes
    from ntracer_tpu_torch.engine import _build
    from ntracer_tpu_torch.engine import resident_kernels as rk
    from ntracer_tpu_torch.engine import wavefront as wf

    t0 = phase("build")
    lib_path = _build.build()
    _build.load()
    print(f"   {os.path.relpath(lib_path, REPO)}")
    with open(os.path.join(_build.BUILD_DIR, "nvcc.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("   " + line.strip())
    done(t0)

    t0 = phase("scene")
    nt = NTracer(4)
    protos = hull_prototypes(nt, polytope_vertices([5, 3, 3]),
                             Material((1, 0.5, 0.5)))
    scene = nt.build_composite_scene(protos)
    cam_distance = -4.0
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, cam_distance))
    scene.set_camera(camera)
    scene.set_fov(0.8)
    cfg, arrs, _flat = wf.get_device_scene(scene, dev)
    print(f"   flagship: {len(protos)} simplices, pool "
          f"{tuple(arrs['res_gt'].shape)}, d={cfg.d}")
    nt6 = NTracer(6)
    lit, lit_camera = lit_scene(nt6, Material)
    lit_distance = -8.0
    lcfg, larrs, _flat = wf.get_device_scene(lit, dev)
    print(f"   lit: 900 simplices, pool {tuple(larrs['res_gt'].shape)}, "
          f"d={lcfg.d}, {lcfg.n_point_lights} point and "
          f"{lcfg.n_global_lights} global lights, shadows {lcfg.shadows}")
    done(t0)

    fmt = ImageFormat(W, H, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])
    buf = bytearray(fmt.pitch * fmt.height)
    fmt_key = wf.packing.format_key(fmt)
    groups = wf._frame_groups(-(-(W * H) // wf.TILE))
    xs, ys, _unswz = wf._frame_coords(groups, W, dev)

    def primary(sc, cfg_, arrs_):
        """The frame's primary wavefront (1,048,576 rays, in the frame's
        block order) and its hits."""
        fov_ = wf._fov_params(W, H, sc.fov)
        cam_o_ = torch.as_tensor(sc._cam._origin, device=dev)
        cam_t_ = torch.as_tensor(sc._cam._t, device=dev)
        oT_, dT_ = wf.make_rays(cam_o_, cam_t_, *fov_, xs, ys)
        pctx_ = wf.primary_ctx(arrs_, cfg_, cam_o_)
        skip_ = torch.full((dT_.shape[1],), -1, dtype=torch.int32,
                           device=dev)
        hit_ = wf.trace_pool(arrs_, cfg_, oT_, dT_, skip_,
                             shared_origin=cam_o_, pctx=pctx_)
        return fov_, cam_o_, cam_t_, oT_, dT_, pctx_, skip_, hit_

    # kernel 2.1 in both walk modes at the flagship's full primary
    # wavefront: primary rays with the shared-origin rows and the
    # front-to-back order, and a bounce wavefront (reflections off the
    # primary hits, every other block inactive, each ray skipping the
    # surface it leaves) in pool order; then the lit frame's primary
    # wavefront (d = 6)
    t0 = phase("nearest_hit kernel vs twin")
    fov, cam_o, cam_t, oT, dT, pctx, skip, hit = primary(scene, cfg, arrs)
    lfov, lcam_o, lcam_t, loT, ldT, lpctx, lskip, lhit = primary(
        lit, lcfg, larrs)
    res = wf._res_dict(arrs)
    lres = wf._res_dict(larrs)
    R = dT.shape[1]
    nrm = hit["normalT"]
    sine = -wf._dotT(dT, nrm)
    blk = torch.arange(R, device=dev) // rk.RAY_BLOCK
    modes = {
        "primary": (cfg, arrs, res, oT, dT, skip,
                    dict(order=pctx["order"], sh=pctx["sh_res"])),
        "bounce": (cfg, arrs, res, hit["pointT"],
                   wf._unitT(dT - nrm * (-2 * sine)[None, :]), hit["pid"],
                   dict(active=hit["hit"] & (blk % 2 == 0))),
        "lit primary": (lcfg, larrs, lres, loT, ldT, lskip,
                        dict(order=lpctx["order"], sh=lpctx["sh_res"])),
    }
    near = {}
    for label, (cfg_, arrs_, res_, o_, d_, s_, kw) in modes.items():
        args = (res_, o_, d_, s_, cfg_.d)
        kt, ks, kv = rk.nearest_hit(*args, **kw)
        pt, ps, pv = rk.nearest_hit_ref(*args, **kw)
        torch.cuda.synchronize()
        slot_diff = int((ks != ps).sum())
        t_diff = int((kt.view(torch.int32) != pt.view(torch.int32)).sum())
        vis_diff = int((kv != pv).sum())
        err = float(torch.nan_to_num(torch.abs(kt - pt), nan=float("inf"))
                    .max())
        ms = time_cuda(lambda: rk.nearest_hit(*args, **kw), 20)
        twin_ms = time_cuda(lambda: rk.nearest_hit_ref(*args, **kw), 2)
        read = kw.get("active", torch.ones_like(ks, dtype=torch.bool))
        need = read & (rk._scene_exit_T(o_, d_, res_["b_lo"],
                                        res_["b_hi"]) > 0)
        bound_ms, bound_by = walk_bound(
            cfg_.d, "sh" in kw, need, read, kv, arrs_["res_neff"],
            pool_bytes(arrs_), int("active" in kw), R * 8 + kv.numel() * 4)
        near[label] = dict(ms=ms, plain_ms=twin_ms, bound_ms=bound_ms,
                           bound_by=bound_by, err=err)
        print(f"   {label}: {R} rays, {int(need.sum())} to test, "
              f"{int((ks >= 0).sum())} hits, "
              f"slot diffs {slot_diff}, t bit diffs {t_diff}, visit diffs "
              f"{vis_diff}, max |dt| {err}, visits/block "
              f"{float(kv.float().mean()):.4f}; kernel {ms:.4f} ms, twin "
              f"{twin_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{100 * bound_ms / ms:.1f}% of the bound reached "
              f"[{name_limit}]")
        if slot_diff or t_diff or vis_diff:
            raise SystemExit(f"nearest_hit kernel != twin in {label} mode")
    done(t0)

    # kernel 2.2 at the lit frame's full wavefront: 1,048,576 shadow rays
    # leaving the primary hit points (misses inactive, each ray skipping the
    # surface it lies on) towards the first point light (finite distances)
    # and along the global light (REAL_MAX cut to the pool's box); then the
    # same towards a point light from the flagship's hit points, where most
    # blocks are live; then a wavefront without any active ray
    t0 = phase("occluded kernel vs twin")

    def shadow_rays(arrs_, hit_, light_pos=None, light_dir=None):
        point = torch.where(hit_["hit"][None, :], hit_["pointT"], 0.0)
        if light_pos is not None:
            lv = point - light_pos[:, None]
            dist = rk._sqrt(wf._dotT(lv, lv))
            return point, (lv / dist[None, :]).contiguous(), \
                torch.where(hit_["hit"], dist, 0.0)
        ld = (-light_dir)[:, None].expand_as(point).contiguous()
        exit_t = rk._scene_exit_T(point, ld, arrs_["res_blo"],
                                  arrs_["res_bhi"])
        return point, ld, torch.where(hit_["hit"], exit_t, 0.0)

    flagship_light = torch.tensor([0.0, 3.0, -3.0, 1.0], device=dev)
    cases = {
        "lit point light": (lcfg, larrs, lres, lhit, shadow_rays(
            larrs, lhit, light_pos=larrs["pl_pos"][0])),
        "lit global light": (lcfg, larrs, lres, lhit, shadow_rays(
            larrs, lhit, light_dir=larrs["gl_dir"][0])),
        "flagship point light": (cfg, arrs, res, hit, shadow_rays(
            arrs, hit, light_pos=flagship_light)),
    }
    occ = {}
    for label, (cfg_, arrs_, res_, hit_, (point, dirs, ldist)) in \
            cases.items():
        args = (res_, point, dirs, ldist, hit_["pid"], cfg_.d)
        kb, kv = rk.occluded(*args)
        pb, pv = rk.occluded_ref(*args)
        torch.cuda.synchronize()
        ray_diff = int((kb != pb).sum())
        vis_diff = int((kv != pv).sum())
        ms = time_cuda(lambda: rk.occluded(*args), 20)
        twin_ms = time_cuda(lambda: rk.occluded_ref(*args), 2)
        bound_ms, bound_by = walk_bound(
            cfg_.d, False, ldist > 0, ldist > 0, kv, arrs_["res_neff"],
            pool_bytes(arrs_), 4, R + kv.numel() * 4, early=kb)
        occ[label] = dict(ms=ms, plain_ms=twin_ms, bound_ms=bound_ms,
                          bound_by=bound_by, diff=ray_diff)
        print(f"   {label}: {R} rays, {int((ldist > 0).sum())} active, "
              f"{int(kb.sum())} blocked, blocked diffs {ray_diff}, visit "
              f"diffs {vis_diff}, live blocks {int((kv > 0).sum())}, "
              f"visits/block {float(kv.float().mean()):.4f}; kernel "
              f"{ms:.4f} ms, twin {twin_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), {100 * bound_ms / ms:.1f}% of the bound "
              f"reached [{name_limit}]")
        if ray_diff or vis_diff:
            raise SystemExit(f"occluded kernel != twin: {label}")
        if label.startswith("flagship") and not 0 < int(kb.sum()) < \
                int((ldist > 0).sum()):
            raise SystemExit("the dense occlusion case decides nothing")
    point, dirs, ldist = cases["lit global light"][4]
    dead = torch.zeros_like(ldist)
    kb, kv = rk.occluded(lres, point, dirs, dead, lhit["pid"], lcfg.d)
    if bool(kb.any()) or bool(kv.any()):
        raise SystemExit("a dead wavefront was walked")
    dead_ms = time_cuda(lambda: rk.occluded(lres, point, dirs, dead,
                                            lhit["pid"], lcfg.d), 20)
    dead_bound, _by = walk_bound(lcfg.d, False, dead > 0, dead > 0, kv,
                                 larrs["res_neff"], 0, 4, R + kv.numel() * 4)
    print(f"   dead wavefront: {R} inactive rays, kernel {dead_ms:.4f} ms "
          f"(wrapper included), bound {dead_bound:.4f} ms (bytes) "
          f"[{name_limit}]")
    done(t0)

    t0 = phase("flagship frame")
    renderer = nt_torch.BlockingRenderer()
    rk.nearest_hit.launches = 0
    rk.occluded.launches = 0
    frame_s = orbit(nt, scene, camera, cam_distance, FRAMES, renderer, buf,
                    fmt)
    flag_launches = (rk.nearest_hit.launches, rk.occluded.launches)
    print(f"   launches in {FRAMES + 1} renders: nearest_hit "
          f"{flag_launches[0]}, occluded {flag_launches[1]}")
    if flag_launches[0] < FRAMES + 1:
        raise SystemExit("the flagship path did not go through nearest_hit")
    report_frames("flagship", frame_s, buf, name_limit)

    def stage_times(sc, cfg_, arrs_, extra):
        """Where the device time goes, at the scene's camera (CUDA
        events)."""
        fov_, cam_o_, cam_t_, oT_, dT_, pctx_, skip_, hit_ = primary(
            sc, cfg_, arrs_)
        res_ = wf._res_dict(arrs_)
        dyn = wf._scene_dyn(sc, dev)
        colorsT = wf._ray_colors_T(arrs_, cfg_, dyn, oT_, dT_, pctx=pctx_)
        stages = {
            "raygen": lambda: wf.make_rays(cam_o_, cam_t_, *fov_, xs, ys),
            "frame_prep": lambda: wf.primary_ctx(arrs_, cfg_, cam_o_),
            "walk": lambda: rk.nearest_hit(res_, oT_, dT_, skip_, cfg_.d,
                                           order=pctx_["order"],
                                           sh=pctx_["sh_res"]),
            **extra(hit_),
            "trace_shade": lambda: wf._ray_colors_T(arrs_, cfg_, dyn, oT_,
                                                    dT_, pctx=pctx_),
            "pack": lambda: wf.packing.pack_device_stream(
                colorsT, fmt_key, permute=_unswz),
            "device_frame": lambda: wf.frame_device_arrays(sc, fmt, dev),
        }
        stage_ms = {k: round(time_cuda(f, 5), 4) for k, f in stages.items()}
        packed = wf.frame_device_arrays(sc, fmt, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            packed.cpu()
        stage_ms["pull"] = round(1000 * (time.perf_counter() - t1) / 5, 4)
        return stage_ms

    stage_ms = stage_times(scene, cfg, arrs, lambda hit_: {})
    print(f"   stage ms {json.dumps(stage_ms)} [{name_limit}]")
    done(t0)

    t0 = phase("lit frame")
    rk.nearest_hit.launches = 0
    rk.occluded.launches = 0
    frame_s = orbit(nt6, lit, lit_camera, lit_distance, LIT_FRAMES, renderer,
                    buf, fmt)
    lit_launches = (rk.nearest_hit.launches, rk.occluded.launches)
    print(f"   launches in {LIT_FRAMES + 1} renders: nearest_hit "
          f"{lit_launches[0]}, occluded {lit_launches[1]}")
    if lit_launches[0] < LIT_FRAMES + 1 or \
            lit_launches[1] < 3 * (LIT_FRAMES + 1):
        raise SystemExit("the lit path did not go through both kernels")
    report_frames("lit", frame_s, buf, name_limit)
    # back to the configuration's own view (the orbit ends a quarter turn
    # off it, where hardly a simplex is on screen) for the stage times and
    # the oracle
    lit_camera = nt6.Camera()
    lit_camera.translate(nt6.Vector.axis(2, lit_distance))
    lit.set_camera(lit_camera)

    def shadow_stage(hit_):
        point, lv, ldist = shadow_rays(larrs, hit_,
                                       light_pos=larrs["pl_pos"][0])
        return {"shadow": lambda: wf.occlusion(
            larrs, lcfg, point, lv, ldist, hit_["pid"], clamp_exit=False)}

    stage_ms = stage_times(lit, lcfg, larrs, shadow_stage)
    print(f"   stage ms {json.dumps(stage_ms)} [{name_limit}]")
    done(t0)

    t0 = phase("oracle")
    rng = np.random.RandomState(0)
    oracle_check(scene, wf.frame_colors(scene, W, H, dev),
                 [(int(rng.randint(W)), int(rng.randint(H)))
                  for _ in range(ORACLE_PIXELS)])
    # the lit frame is mostly background: three quarters of its pixels are
    # drawn from the ones that hit a surface.  The oracle's occlusion walk
    # keeps the reference's early-out, which misses occluders of a global
    # light; the engine is any-hit, so the check runs with the exact walk.
    kdnodes.OCCLUDES_EARLY_OUT = False
    colors = wf.frame_colors(lit, W, H, dev)
    _f, _o, _t, _oT, _dT, _p, _s, lhit = primary(lit, lcfg, larrs)
    hit_px = _unswz(lhit["hit"])[:W * H].nonzero().squeeze(1).cpu().numpy()
    print(f"   lit frame: {len(hit_px)} pixels hit a surface")
    if len(hit_px) == 0:
        raise SystemExit("the lit frame hits nothing")
    n_hit = 3 * ORACLE_PIXELS // 4
    picks = [divmod(int(p), W)[::-1] for p in
             rng.choice(hit_px, size=n_hit, replace=len(hit_px) < n_hit)]
    picks += [(int(rng.randint(W)), int(rng.randint(H)))
              for _ in range(ORACLE_PIXELS - n_hit)]
    oracle_check(lit, colors, picks)
    done(t0)

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "ntracer", "ntracer_tpu")]
    if bad:
        raise SystemExit(f"imported {bad}")
    kernels = [
        {"name": "nearest_hit", "route": "cuda",
         "source": "ntracer_tpu_torch/csrc/nearest_hit.cu",
         "replaces": "ntracer_tpu/engine/resident_kernels.py:778",
         "launches": flag_launches[0],
         "launches_by_path": {"flagship": flag_launches[0],
                              "lit": lit_launches[0]},
         "max_abs_err": max(v["err"] for v in near.values()),
         "ms": near["primary"]["ms"], "plain_ms": near["primary"]["plain_ms"],
         "bound_ms": near["primary"]["bound_ms"],
         "bound_by": near["primary"]["bound_by"], "library_ms": None,
         "cases": near},
        {"name": "occluded", "route": "cuda",
         "source": "ntracer_tpu_torch/csrc/occluded.cu",
         "replaces": "ntracer_tpu/engine/resident_kernels.py:1100",
         "launches": lit_launches[1],
         "launches_by_path": {"flagship": flag_launches[1],
                              "lit": lit_launches[1]},
         "max_abs_err": float(max(v["diff"] for v in occ.values())),
         "ms": occ["lit point light"]["ms"],
         "plain_ms": occ["lit point light"]["plain_ms"],
         "bound_ms": occ["lit point light"]["bound_ms"],
         "bound_by": occ["lit point light"]["bound_by"],
         "library_ms": None,
         "cases": occ, "dead_ms": dead_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
