"""ntracer_tpu_torch host prep vs the JAX package, array by array: scene
flattening, centroid bins, chunk layouts and the device scene."""

import dataclasses

import numpy as np
import pytest
import torch

from ntracer_tpu.engine import flatten as jflat
from ntracer_tpu.engine import resident_kernels as jrk
from ntracer_tpu_torch import NTracer
from ntracer_tpu_torch.engine import flatten as pflat
from ntracer_tpu_torch.engine import resident_kernels as prk
from ntracer_tpu_torch.engine import wavefront as pwf

from _torch_helpers import (JAX, PORT, random_scene, polytope_scene,
                            reflective_scene, jax_device_scene)

# each package flattens a scene of its own classes, built from one seed
SCENES = {
    "3d_random": lambda pkg=PORT: random_scene(3, n=700, seed=3, pkg=pkg),
    "4d_600cell": lambda pkg=PORT: polytope_scene(pkg=pkg),
    "3d_reflective_lit": lambda pkg=PORT: reflective_scene(pkg=pkg),
}


def _assert_same_array(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{name}: {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{name}: {a.shape} != {b.shape}"
    assert np.array_equal(a, b), f"{name} differs"


@pytest.mark.parametrize("name", sorted(SCENES))
def test_flatten_matches_jax(name):
    ref = jflat.flatten_composite(SCENES[name](JAX), chunk=512)
    got = pflat.flatten_composite(SCENES[name](), chunk=512)
    ref_cfg = dataclasses.asdict(ref.config)
    assert ref_cfg.pop("prim_axis") is None
    assert dataclasses.asdict(got.config) == ref_cfg
    assert sorted(got.arrays) == sorted(ref.arrays)
    for k in ref.arrays:
        _assert_same_array(got.arrays[k], ref.arrays[k], k)
    assert [(type(o).__name__, i) for o, i in got.prim_objects] == \
        [(type(o).__name__, i) for o, i in ref.prim_objects]
    assert all(type(o).__module__ == "ntracer_tpu_torch.primitives"
               for o, _ in got.prim_objects)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_centroid_bins_and_cells_match_jax(name):
    flat = pflat.flatten_composite(SCENES[name](), chunk=512)
    a = flat.arrays
    d = flat.config.d
    fn_norm = np.linalg.norm(a["tri_fn"], axis=1)
    ref_bins = jrk.centroid_bins(a["cull_lo"], a["cull_hi"], fn_norm, jrk.CK)
    bins = prk.centroid_bins(a["cull_lo"], a["cull_hi"], fn_norm, prk.CK)
    assert len(bins) == len(ref_bins) > 1
    for (lo, hi, ids), (rlo, rhi, rids) in zip(bins, ref_bins):
        _assert_same_array(lo, rlo, "bin lo")
        _assert_same_array(hi, rhi, "bin hi")
        assert list(ids) == list(rids)
    args = (a["tri_p1"], a["tri_fn"], a["tri_en"], a["tri_dc"],
            a["cull_lo"], a["cull_hi"], d)
    ref = jrk.prepare_resident_cells(ref_bins, *args, tri_mat=a["tri_mat"])
    got = prk.prepare_resident_cells(bins, *args, tri_mat=a["tri_mat"])
    assert sorted(got) == sorted(ref)
    for k in ref:
        _assert_same_array(got[k], ref[k], k)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_device_arrays_match_jax(name, monkeypatch):
    """Every array of the port's device scene (the chunk layouts and
    res_slot_pack included) equals the JAX engine's array of that name."""
    _cfg, ref, _flat = jax_device_scene(SCENES[name](JAX), monkeypatch)
    got = pwf.device_arrays(pflat.flatten_composite(SCENES[name](),
                                                    chunk=512))
    assert "res_slot_pack" in got and "res_gt" in got
    for k, v in got.items():
        assert k in ref, k
        _assert_same_array(v, ref[k], k)


def test_tensors_from_arrays_round_trip(monkeypatch):
    _cfg, arrs, _flat = jax_device_scene(polytope_scene(pkg=JAX),
                                         monkeypatch)
    tens = pwf.tensors_from_arrays(arrs, "cpu")
    # every array, plus the pool-order chunk boxes made once per scene
    assert sorted(tens) == sorted([*arrs, "res_base_boxes"])
    res = pwf._res_dict(tens)
    for got, want in zip(tens["res_base_boxes"], prk._order_boxes(
            res, res["base_order"], arrs["res_klo"].shape[1])):
        assert torch.equal(got, want)
    for k, v in arrs.items():
        if k == "res_neff":
            assert tens[k] == int(v[0])
            continue
        t = tens[k]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        _assert_same_array(t.numpy(), v, k)


def test_device_scene_cache_keyed_on_version():
    """The port caches on ``_torch_cache`` keyed on the scene version and
    the device, re-reads render flags per call, and drops the cache when
    the scene's geometry or lights change."""
    scene = random_scene(3, n=200, seed=1)
    assert scene._torch_cache is None
    cfg, arrs, _ = pwf.get_device_scene(scene, "cpu")
    assert pwf.get_device_scene(scene, "cpu")[1] is arrs
    scene.set_max_reflect_depth(2)
    scene.set_camera_light(False)
    cfg2, arrs2, _ = pwf.get_device_scene(scene, "cpu")
    assert arrs2 is not arrs
    assert cfg2.max_reflect_depth == 2 and not cfg2.camera_light
    assert cfg.max_reflect_depth == 4 and cfg.camera_light
    for k, v in arrs.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, arrs2[k]), k
    assert scene._torch_cache is not None
    nt = NTracer(3)
    scene.add_light(nt.GlobalLight(nt.Vector(0, -1, 0), (1, 1, 1)))
    assert scene._torch_cache is None
