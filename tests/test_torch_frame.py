"""Frames of ntracer_tpu_torch vs the JAX package and the scalar oracle:
ray order, ray generation, channel packing, BoxScene and composite frames,
the renderer's contract, and what the port refuses."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntracer_tpu.engine import wavefront as jwf
from ntracer_tpu.engine import packing as jpack
import ntracer_tpu
from ntracer_tpu.render import BlockingRenderer as JaxRenderer
import ntracer_tpu_torch
from ntracer_tpu_torch import (BlockingRenderer, NTracer, CUBE, ImageFormat,
                               Channel, Material, LockedError)
from ntracer_tpu_torch.engine import wavefront as pwf
from ntracer_tpu_torch.engine import packing as ppack

from _torch_helpers import (REPO, JAX, PORT, api, random_scene, polytope_scene,
                            reflective_scene, rgb8, formats,
                            jax_device_scene)

W = H = 64


@pytest.mark.parametrize("start,w,count", [
    (0, 64, 32768),          # 32x16 tiles
    (32768, 1024, 32768),    # a later group of a 1024-wide frame
    (0, 96, 32768),          # 32768 % 96 != 0: linear order
    (0, 40, 32768),          # width not a multiple of 32: linear order
])
def test_ray_coords_match_jax(start, w, count):
    xs, ys, swz = jwf._ray_coords(jnp.int32(start), w, count)
    pxs, pys, pswz = pwf._ray_coords(start, w, count, "cpu")
    assert np.array_equal(pxs.numpy(), np.asarray(xs))
    assert np.array_equal(pys.numpy(), np.asarray(ys))
    assert (swz is None) == (pswz is None)
    if swz is not None:
        idx = np.arange(count, dtype=np.int32)
        ref = np.asarray(swz(jnp.asarray(idx)[:, None]))[:, 0]
        assert np.array_equal(pswz(torch.from_numpy(idx)).numpy(), ref)


@pytest.mark.parametrize("w,h", [(64, 64), (1024, 1024), (200, 150)])
def test_make_rays_matches_jax(w, h):
    """Bit for bit the strict float32 evaluation (one rounding per
    operation, sums left to right); within one float32 ulp of 1 of the JAX
    package on the CPU, whose XLA programs contract a*b+c into FMAs and
    order the norm's sum their own way."""
    scene = polytope_scene()
    fov = pwf._fov_params(w, h, 0.8)
    assert fov == tuple(float(v) for v in jwf._fov_params(w, h, 0.8))
    start, count = pwf._frame_groups(-(-(w * h) // pwf.TILE))[-1]
    xs, ys, _ = pwf._ray_coords(start, w, count, "cpu")
    cam_o = np.asarray(scene._cam._origin, np.float32)
    cam_t = np.asarray(scene._cam._t, np.float32)
    oT, dT = pwf.make_rays(torch.from_numpy(cam_o), torch.from_numpy(cam_t),
                           *fov, xs, ys)
    # strict float32, one rounding per operation, sums left to right
    f32 = np.float32
    a = f32(fov[0]) * (xs.numpy() - f32(fov[1]))
    b = f32(fov[0]) * (ys.numpy() - f32(fov[2]))
    v = (cam_t[2][:, None] + cam_t[0][:, None] * a) - cam_t[1][:, None] * b
    n2 = v[0] * v[0]
    for c in range(1, v.shape[0]):
        n2 = n2 + v[c] * v[c]
    assert np.array_equal(dT.numpy(), v / np.sqrt(n2))
    assert np.array_equal(oT.numpy(), np.broadcast_to(cam_o[:, None],
                                                       v.shape))
    o, dirs = jwf.make_rays(jnp.asarray(cam_o), jnp.asarray(cam_t),
                            *jwf._fov_params(w, h, 0.8), jnp.asarray(xs),
                            jnp.asarray(ys))
    np.testing.assert_array_equal(oT.numpy(), np.asarray(o).T)
    np.testing.assert_allclose(dT.numpy(), np.asarray(dirs).T, rtol=0,
                               atol=2.0 ** -23)


@pytest.mark.parametrize("name", sorted(formats(1, 1)))
def test_packed_bytes_match_jax(name):
    fmt = formats(4, 1024)[name]
    key = ppack.format_key(fmt)
    assert key == jpack.format_key(fmt)
    rng = np.random.RandomState(3)
    colors = rng.uniform(-0.2, 1.2, (3, 4096)).astype(np.float32)
    # exact code boundaries and the clamp ends
    colors[:, :256] = (np.arange(256, dtype=np.float32) + 0.5) / 255
    colors[:, 256:264] = [0, 1, -0.0, 1.0000001, 0.5, 0.25, 2, -2]
    ref = np.asarray(jpack.pack_device_stream(jnp.asarray(colors), key,
                                              colors_T=True))
    got = ppack.pack_device_stream(torch.from_numpy(colors), key)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert got.numpy().tobytes() == ref.tobytes()


@pytest.mark.parametrize("d", [4, 10])
def test_box_scene_bytes_match_jax(d):
    """BoxScene needs no walk: ray order, unswizzle and packing alone.
    Each renderer gets the box scene of its own package; at d = 10 the
    generic (any-dimension) modules of both."""
    scenes = []
    for nt in (api(JAX).NTracer(d), NTracer(d)):
        scene = nt.BoxScene()
        cam = nt.Camera()
        cam.translate(nt.Vector.axis(2, -3))
        cam.transform(nt.Matrix.rotation(cam.axes[2], cam.axes[0], 0.4))
        scene.set_camera(cam)
        scenes.append(scene)
    for fmt in (rgb8(96, 48), formats(64, 32)["rgb565"]):
        ref = bytearray(fmt.pitch * fmt.height)
        got = bytearray(fmt.pitch * fmt.height)
        assert JaxRenderer().render(ref, fmt, scenes[0])
        assert BlockingRenderer(device="cpu").render(got, fmt, scenes[1])
        assert got == ref


def _jax_frame_colors(scene, w, h):
    """The JAX package's single-device frame path (dispatch_packed's
    slabs) with raw float colors, as (h, w, 3)."""
    cfg, device, _flat = jwf.get_device_scene(scene)
    fa = jwf._frame_args(scene, w, h)
    n_tiles = -(-(w * h) // jwf.TILE)
    n_slabs = max(1, min(4, n_tiles // 4))
    per = -(-n_tiles // n_slabs)
    out = []
    for s0 in range(0, n_tiles, per):
        out.append(np.asarray(jwf._frame_packed_composite(
            device, cfg, fa["dyn"], fa["cam"][0], fa["cam"][1], fa["fov"],
            jwf._frame_base(fa, s0 * jwf.TILE), w, min(per, n_tiles - s0),
            None)))
    return np.concatenate(out)[:w * h].reshape(h, w, 3)


FRAME_SCENES = {
    "4d_600cell": lambda pkg: polytope_scene(pkg=pkg),
    "3d_reflective": lambda pkg: reflective_scene(pkg=pkg),
}


@pytest.mark.parametrize("name", sorted(FRAME_SCENES))
def test_composite_frame_matches_jax_and_oracle(name, monkeypatch):
    jscene = FRAME_SCENES[name](JAX)
    pscene = FRAME_SCENES[name](PORT)
    if name == "3d_reflective":
        for s in (jscene, pscene):
            s.set_max_reflect_depth(2)
    jcfg, _arrs, _ = jax_device_scene(jscene, monkeypatch)
    pcfg, parrs, _ = pwf.get_device_scene(pscene, "cpu")
    assert pcfg == pwf.SceneConfig(**{k: v for k, v in vars(jcfg).items()
                                      if k != "prim_axis"})

    # primary winners on the frame's first dispatch group
    scene_ = pscene
    scene_._set_view_size(W, H)
    fov = pwf._fov_params(W, H, scene_.fov)
    xs, ys, _ = pwf._ray_coords(0, W, pwf.TILE, "cpu")
    cam_o = torch.from_numpy(np.asarray(scene_._cam._origin, np.float32))
    cam_t = torch.from_numpy(np.asarray(scene_._cam._t, np.float32))
    oT, dT = pwf.make_rays(cam_o, cam_t, *fov, xs, ys)
    skip = torch.full((pwf.TILE,), -1, dtype=torch.int32)
    pres = pwf.trace_pool(parrs, pcfg, oT, dT, skip, shared_origin=cam_o)
    jdev = jwf.get_device_scene(jscene)[1]
    jres = jwf.trace_pool(jdev, jcfg, jnp.asarray(oT.numpy().T),
                          jnp.asarray(dT.numpy().T),
                          jnp.asarray(skip.numpy()),
                          shared_origin=jnp.asarray(cam_o.numpy()),
                          transposed=True)
    assert int(pres["hit"].sum()) > 200
    assert np.array_equal(pres["pid"].numpy(), np.asarray(jres["pid"]))

    # float colors of the whole frame
    ref = _jax_frame_colors(jscene, W, H)
    got = pwf.frame_colors(pscene, W, H, "cpu")
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)

    # packed bytes through the port's renderer: within one code of JAX's
    fmt = rgb8(W, H)
    buf = bytearray(fmt.pitch * H)
    assert BlockingRenderer(device="cpu").render(buf, fmt, pscene)
    ref_bytes = np.asarray(jpack.pack_device(
        jnp.asarray(ref.reshape(-1, 3)), jpack.format_key(fmt)))
    diff = np.abs(np.frombuffer(bytes(buf), np.uint8).astype(int)
                  - ref_bytes.reshape(-1).astype(int))
    assert diff.max() <= 1

    # the scalar oracle at seeded pixels
    pscene._set_view_size(W, H)
    rng = np.random.RandomState(1)
    worst = 0.0
    for _ in range(64):
        x, y = int(rng.randint(W)), int(rng.randint(H))
        worst = max(worst, float(np.abs(pscene._pixel_color(x, y)
                                        - got[y, x]).max()))
    assert worst < 5e-5, f"worst port-vs-oracle diff {worst}"


def test_powf_matches_jax():
    x = np.array([-2, -2, -2, -0.5, 0, 0.5, 2, -3, -1.5], np.float32)
    y = np.array([2, 3, 2.5, 8, 3, 8, 0.5, 1, 4], np.float32)
    ref = np.asarray(jwf._powf(jnp.asarray(x), jnp.asarray(y)))
    got = pwf._powf(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert got[1] < 0 and np.isnan(got[2])


def _scene_with(feature, pkg=PORT):
    a = api(pkg)
    if feature == "d9":
        return random_scene(9, n=4, seed=1,
                            material=a.Material((1, 1, 1), opacity=0.5),
                            pkg=pkg)
    if feature == "transparency":
        return random_scene(3, n=20, seed=1,
                            material=a.Material((1, 1, 1), opacity=0.5),
                            pkg=pkg)
    nt = a.NTracer(3)
    if feature == "shadows_transparent":
        scene = random_scene(3, n=20, seed=1,
                             material=a.Material((1, 1, 1), opacity=0.5),
                             pkg=pkg)
        scene.add_light(nt.PointLight(nt.Vector(0, 4, -4), (1, 1, 1)))
        scene.set_shadows(True)
        return scene
    assert feature == "solid"
    protos = [nt.TrianglePrototype([nt.Vector(0, 0, 0), nt.Vector(1, 0, 0),
                                    nt.Vector(0, 1, 0)],
                                   a.Material((1, 1, 1))),
              nt.SolidPrototype(CUBE, nt.Vector(0, 0, 2),
                                nt.Matrix.identity(), a.Material((1, 1, 1)))]
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, -8))
    scene.set_camera(cam)
    return scene


@pytest.mark.parametrize("feature,item", [("shadows_transparent", None),
                                          ("transparency", None),
                                          ("solid", 8), ("d9", 10)])
def test_unsupported_scenes_raise(feature, item, monkeypatch):
    """Scenes the port once refused render.  Solids and a transparent scene
    with d > 8 ("d9"), which ROADMAP items 8 and 10 brought, equal the JAX
    package's frame of the same scene (colors to rtol 2e-6, bytes within
    one code); the transparent scenes of d <= 8 (item None): the glass
    changes the frame.  The scene is unlocked afterwards."""
    scene = _scene_with(feature)
    fmt = rgb8(32, 32)
    buf = bytearray(fmt.pitch * 32)
    assert BlockingRenderer(device="cpu").render(buf, fmt, scene)
    assert not scene.locked
    if item is not None:
        jscene = _scene_with(feature, pkg=JAX)
        if feature == "solid":
            jax_device_scene(jscene, monkeypatch)
        ref = _jax_frame_colors(jscene, 32, 32)
        got = pwf.frame_colors(scene, 32, 32, "cpu")
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-7)
        ref_bytes = np.asarray(jpack.pack_device(
            jnp.asarray(ref.reshape(-1, 3)), jpack.format_key(fmt)))
        diff = np.abs(np.frombuffer(bytes(buf), np.uint8).astype(int)
                      - ref_bytes.reshape(-1).astype(int))
        assert diff.max() <= 1
        cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
        assert cfg.n_solids == 1 if feature == "solid" else pwf._scan(arrs)
        return
    cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    assert cfg.has_transparency and "res_opa" in arrs
    glass = pwf.frame_colors(scene, 32, 32, "cpu")
    opaque_scene = random_scene(3, n=20, seed=1, material=Material((1, 1, 1)))
    for light in scene.point_lights:
        opaque_scene.add_light(light)
    opaque_scene.set_shadows(scene.shadows)
    opaque = pwf.frame_colors(opaque_scene, 32, 32, "cpu")
    assert np.isfinite(glass).all()
    # the background shows through the glass
    assert (np.abs(glass - opaque).max(axis=2) > 1e-3).sum() > 20


def test_scene_of_the_other_package_raises():
    """The two packages' scene classes are distinct: a scene built by
    ntracer_tpu handed to the port's renderer raises a TypeError that says
    so, rather than flattening to an empty pool."""
    fmt = rgb8(32, 32)
    buf = bytearray(fmt.pitch * 32)
    nt = api(JAX).NTracer(3)
    for scene in (random_scene(3, n=10, seed=1, pkg=JAX), nt.BoxScene()):
        with pytest.raises(TypeError, match="ntracer_tpu_torch.NTracer"):
            BlockingRenderer(device="cpu").render(buf, fmt, scene)
        assert not scene.locked
    with pytest.raises(TypeError, match="ntracer_tpu_torch.NTracer"):
        pwf.get_device_scene(random_scene(3, n=10, seed=1, pkg=JAX), "cpu")


def test_wide_integer_channels_raise():
    """A 24-bit integer channel (ROADMAP item 13) renders: its bytes are the
    exact host packer's of the frame's float colors."""
    fmt = ImageFormat(32, 32, [Channel(24, 1, 0, 0), Channel(8, 0, 1, 0)])
    scene = random_scene(3, n=10, seed=1)
    buf = bytearray(fmt.pitch * 32)
    assert BlockingRenderer(device="cpu").render(buf, fmt, scene)
    colors = pwf.frame_colors(scene, 32, 32, "cpu")
    assert bytes(buf) == ppack.pack_rows(colors, fmt).tobytes()
    assert any(buf)


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockingRenderer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockingRenderer(device="cuda")
    with pytest.raises(ValueError):
        BlockingRenderer(device="meta")
    assert BlockingRenderer(device="cpu").device == torch.device("cpu")


def test_renderer_lock_and_abort_contract(monkeypatch):
    """The scene is locked while the frame renders, a second render on the
    same renderer raises, an abort makes render return False, and both
    flags reset afterwards."""
    scene = random_scene(3, n=50, seed=4)
    fmt = rgb8(32, 32)
    buf = bytearray(fmt.pitch * 32)
    r = BlockingRenderer(device="cpu")
    seen = []

    def fake_render(sc, fmt_, view, abort_check, device):
        assert sc.locked and device == torch.device("cpu")
        with pytest.raises(LockedError):
            sc.set_fov(1.0)
        with pytest.raises(RuntimeError, match="already running"):
            r.render(buf, fmt_, sc)
        r.signal_abort()
        seen.append(abort_check())
        return not abort_check()

    monkeypatch.setattr(pwf, "render_packed", fake_render)
    assert r.render(buf, fmt, scene) is False
    assert seen == [True] and not scene.locked and not r._abort
    monkeypatch.undo()
    assert r.render(buf, fmt, scene) is True
    with pytest.raises(ValueError):
        r.render(bytearray(10), fmt, scene)


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        "import ntracer_tpu_torch\n"
        "from ntracer_tpu_torch import BlockingRenderer\n"
        "from _torch_helpers import random_scene, rgb8\n"
        "scene = random_scene(3, n=40, seed=2)\n"
        "fmt = rgb8(32, 32)\n"
        "buf = bytearray(fmt.pitch * 32)\n"
        "assert BlockingRenderer(device='cpu').render(buf, fmt, scene)\n"
        "assert any(buf)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'ntracer_tpu' not in sys.modules, 'ntracer_tpu was imported'\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "NTRACER_PLATFORM"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_package_exports():
    for name in ("Color", "Material", "Channel", "ImageFormat", "NTracer",
                 "CUBE", "SPHERE", "BlockingRenderer"):
        assert name in ntracer_tpu_torch.__all__
    # the port's names are its own, never the JAX package's objects
    for name in ntracer_tpu_torch.__all__:
        obj = getattr(ntracer_tpu_torch, name)
        if isinstance(obj, int):        # CUBE, SPHERE
            continue
        mod = getattr(obj, "__module__", None) or obj.__name__
        assert mod.startswith("ntracer_tpu_torch"), name
        assert obj is not getattr(ntracer_tpu, name, None), name
    assert ntracer_tpu_torch.BlockingRenderer is not JaxRenderer
    nt = ntracer_tpu_torch.NTracer(5)
    assert nt.base.__name__ == "ntracer_tpu_torch.tracer5"
    assert type(nt.Vector(1, 2, 3, 4, 5)).__module__ == "ntracer_tpu_torch.api"
