"""How ntracer_tpu_torch builds its CUDA kernels (the build itself needs
nvcc and a card, so it runs only there: chip_smoke.py)."""

import os
import re
import shutil

import pytest

from ntracer_tpu_torch.engine import _build


def test_nvcc_command_targets_hopper_with_ieee_math():
    cmd = _build.nvcc_command("a.cu", "/tmp/a.o")
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "--fmad=false" in cmd
    assert "-prec-div=true" in cmd and "-prec-sqrt=true" in cmd
    assert not any("fast_math" in a or "fast-math" in a for a in cmd)
    assert cmd[-4:] == ["-c", "-o", "/tmp/a.o", "a.cu"]
    link = _build.link_command(["a.o", "b.o"], "/tmp/lib.so")
    assert link[-5:] == ["-shared", "-o", "/tmp/lib.so", "a.o", "b.o"]


def test_sources_and_build_dir():
    srcs = _build.sources()
    assert [os.path.basename(s) for s in srcs] == [
        "nearest_hit.cu", "nearest_hit_transparent.cu", "occluded.cu",
        "occluded_transparent.cu"]
    assert [os.path.basename(s) for s in _build.headers()] == [
        "chunk_ring.cuh", "pair_test.cuh"]
    pkg = os.path.dirname(os.path.dirname(_build.__file__))
    assert all(os.path.dirname(s) == os.path.join(pkg, "csrc")
               for s in srcs + _build.headers())
    # the C++ k-d builder lives beside them and never goes to nvcc
    assert os.path.exists(os.path.join(pkg, "csrc", "kd_builder.cpp"))
    assert not any(s.endswith(".cpp") for s in srcs + _build.headers())
    assert _build.BUILD_DIR == os.path.join(os.path.dirname(pkg), "build",
                                            "ntracer_tpu_torch")
    lib = _build.library_path()
    assert os.path.dirname(lib) == _build.BUILD_DIR
    assert lib == _build.library_path()         # stable name per content


@pytest.mark.parametrize("name", ["nearest_hit.cu", "occluded.cu",
                                  "nearest_hit_transparent.cu",
                                  "occluded_transparent.cu", "pair_test.cuh",
                                  "chunk_ring.cuh"])
def test_library_name_follows_every_build_input(name, tmp_path, monkeypatch):
    """An edit to any source or header the build reads changes the
    library's name, so a stale library is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    before = _build.library_path()
    with open(csrc / name, "a") as f:
        f.write("// edited\n")
    assert _build.library_path() != before
    # the k-d builder's source is no input of the CUDA library
    after = _build.library_path()
    with open(csrc / "kd_builder.cpp", "a") as f:
        f.write("// edited\n")
    assert _build.library_path() == after


def _check_signature(fn, argtypes, source):
    """The argtypes bound with ctypes have one entry per parameter of the
    C function, pointers as c_void_p and ints as c_int."""
    src = open(os.path.join(_build.CSRC_DIR, source)).read()
    m = re.search(r"int %s\((.*?)\)\s*\{" % fn, src, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        want = _build._P if "*" in p else _build._I
        assert t is want, p


def test_ctypes_signature_matches_the_c_entry_point():
    _check_signature("ntr_nearest_hit", _build._NEAREST_ARGS,
                     "nearest_hit.cu")


def test_occluded_ctypes_signature_matches_the_c_entry_point():
    _check_signature("ntr_occluded", _build._OCCLUDED_ARGS, "occluded.cu")


@pytest.mark.parametrize("fn,argtypes,source", [
    ("ntr_nearest_t", "_NEAREST_T_ARGS", "nearest_hit_transparent.cu"),
    ("ntr_occluded_t", "_OCCLUDED_T_ARGS", "occluded_transparent.cu")])
def test_transparent_ctypes_signatures_match_the_c_entry_points(
        fn, argtypes, source):
    _check_signature(fn, getattr(_build, argtypes), source)
    # load() binds the entry point with these argtypes
    src = open(_build.__file__).read()
    assert f"lib.{fn}.argtypes = {argtypes}" in src


@pytest.mark.parametrize("fn,argtypes,source", [
    ("ntr_nearest_hit_hbm", "_NEAREST_ARGS", "nearest_hit.cu"),
    ("ntr_occluded_hbm", "_OCCLUDED_ARGS", "occluded.cu"),
    ("ntr_nearest_t_hbm", "_NEAREST_T_ARGS", "nearest_hit_transparent.cu"),
    ("ntr_occluded_t_hbm", "_OCCLUDED_T_ARGS", "occluded_transparent.cu")])
def test_streaming_ctypes_signatures_match_the_c_entry_points(
        fn, argtypes, source):
    """The streaming walks (kernels 2.5-2.8) take their resident sibling's
    arguments, and load() binds them so."""
    _check_signature(fn, getattr(_build, argtypes), source)
    src = open(_build.__file__).read()
    assert f'("{fn}", {argtypes})' in src
