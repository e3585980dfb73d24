"""The plain reference: the pixels of a frame of an opaque simplex scene,
worked out from the simplices and the camera alone.

Plain PyTorch.  It imports nothing of the program: it is given the
simplices and the float32 camera the benchmark made, and the scene's
settings from the configuration file, and it finds everything else itself.

What a pixel is (NTracer's composite scene with no lights, no reflection
and opaque materials, tracer.hpp:1768-1890 and render.cpp:396-466):

- its ray leaves the camera origin along ``unit(fwd + right * fovI * (x -
  W/2) - up * fovI * (y - H/2))``, ``fovI = tan(fov / 2) / (W / 2)``;
- it hits the nearest simplex with ``t > 0`` whose barycentric
  coordinates all lie in [0, 1] (solved exactly here, with no fuzz);
- a hit's color is ``specular + (ambient + material * sine) * (1 -
  spec_a)`` with ``sine = |dir . n|`` (the camera light), ``base = sine ** specular_exp *
  specular_intensity``, ``spec_a = base`` and ``specular =
  specular_color * base * base``;
- a miss's color is the background gradient along ``bg_axis``;
- each channel is ``lround(clamp(c, 0, 1) * (2 ** bits - 1))``.

``dtype`` is the precision every step runs in: float64 for the reference,
a lower one for the control that shows the comparison can fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def simplex_rows(tris, dtype, device):
    """Per simplex: its unit normal n (T, d), n . p0 (T,), the barycentric
    solver G (T, d-1, d) with b = G (x - p0), and G p0 (T, d-1).  Worked out
    in float64, or from the vertices rounded to ``dtype`` in float32 when
    ``dtype`` is lower (torch solves in float32 at least)."""
    p = torch.as_tensor(np.asarray(tris), device=device)
    work = torch.float64 if dtype == torch.float64 else torch.float32
    p = p.to(dtype).to(work)
    p0 = p[:, 0]
    e = p[:, 1:] - p0[:, None]                       # (T, d-1, d)
    n = torch.linalg.svd(e)[2][:, -1]                # null vector of the edges
    g = torch.linalg.solve(e @ e.transpose(1, 2), e)  # (T, d-1, d)
    rows = dict(n=n, c=(n * p0).sum(1), g=g,
                gp0=torch.einsum("tij,tj->ti", g, p0))
    return {k: v.to(dtype) for k, v in rows.items()}


def pixel_rays(origin, axes, fov, width, height, xs, ys, dtype, device):
    """Directions (R, d) of the pixels ``xs``, ``ys`` (integer arrays).  The
    screen offsets are exact inputs; the directions are worked out in
    ``dtype``."""
    ax = torch.as_tensor(np.asarray(axes), device=device).to(dtype)
    fov_i = math.tan(fov / 2) / (width / 2)
    a = torch.as_tensor((np.asarray(xs) - width / 2) * fov_i,
                        device=device).to(dtype)
    b = torch.as_tensor((np.asarray(ys) - height / 2) * fov_i,
                        device=device).to(dtype)
    v = ax[2][None] + a[:, None] * ax[0][None] - b[:, None] * ax[1][None]
    return v / torch.sqrt((v * v).sum(1, keepdim=True))


def nearest(rows, origin, dirs, block):
    """Nearest hit of every ray: (t (R,), index (R,), -1 for none)."""
    dtype = dirs.dtype
    o = torch.as_tensor(np.asarray(origin), device=dirs.device).to(dtype)
    n_all, g_all = rows["n"], rows["g"]
    no_all = n_all @ o                                  # (T,)
    go_all = torch.einsum("tij,j->ti", g_all, o) - rows["gp0"]   # (T, d-1)
    best_t = torch.full((dirs.shape[0],), math.inf, dtype=dtype,
                        device=dirs.device)
    best_i = torch.full((dirs.shape[0],), -1, dtype=torch.int64,
                        device=dirs.device)
    for s in range(0, n_all.shape[0], block):
        n, g = n_all[s:s + block], g_all[s:s + block]
        nv = dirs @ n.T                                 # (R, T)
        t = (rows["c"][s:s + block] - no_all[s:s + block])[None] / nv
        gv = torch.einsum("rj,tij->rti", dirs, g)       # (R, T, d-1)
        bary = go_all[s:s + block][None] + t[..., None] * gv
        ok = (nv != 0) & (t > 0) & (bary >= 0).all(2) & (bary.sum(2) <= 1)
        t = torch.where(ok, t, math.inf)
        tmin, imin = t.min(1)
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, imin + s, best_i)
    return best_t, best_i


def shade(rows, dirs, hit_i, scene):
    """Float colors (R, 3) of the rays, as ``dirs.dtype``."""
    dtype, dev = dirs.dtype, dirs.device

    def col(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    m = scene["material"]
    hit = hit_i >= 0
    n = rows["n"][hit_i.clamp(min=0)]
    sine = (dirs * n).sum(1).abs()
    base = sine ** float(m["specular_exp"]) * float(m["specular_intensity"])
    specular = col(m["specular_color"])[None] * (base * base)[:, None]
    lit = col(m["color"])[None] * sine[:, None]
    hit_c = specular + (col(scene["ambient"])[None] + lit) \
        * (1 - base)[:, None]
    bg = scene["background"]
    i = dirs[:, int(bg["axis"])][:, None]
    up = col(bg["bg1"])[None] * i + col(bg["bg2"])[None] * (1 - i)
    down = col(bg["bg3"])[None] * -i + col(bg["bg2"])[None] * (1 + i)
    miss_c = torch.where(i >= 0, up, down)
    return torch.where(hit[:, None], hit_c, miss_c)


def quantize(colors, bits):
    """lround(clamp(c, 0, 1) * (2^bits - 1)) as int64 (the rounding in
    float64, whatever precision the colors were worked out in)."""
    scale = float((1 << bits) - 1)
    c = colors.to(torch.float64).clamp(0, 1)
    return torch.floor(c * scale + 0.5).to(torch.int64)


def pixels(tris, scene, origin, axes, width, height, xs, ys, bits,
           dtype=torch.float64, device="cpu", block=4096, rows=None):
    """The channel values (R, 3) int64 of the pixels ``xs``, ``ys``.
    ``rows`` (from ``simplex_rows``) may be passed to reuse them."""
    rows = rows if rows is not None else simplex_rows(tris, dtype, device)
    dirs = pixel_rays(origin, axes, float(scene["fov"]), width, height, xs,
                      ys, dtype, device)
    _t, idx = nearest(rows, origin, dirs, block)
    return quantize(shade(rows, dirs, idx, scene), bits)
