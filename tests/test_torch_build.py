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
        "grid_walk.cu", "nearest_hit.cu", "nearest_hit_transparent.cu",
        "occluded.cu", "occluded_transparent.cu", "shade_pack.cu"]
    assert [os.path.basename(s) for s in _build.headers()] == [
        "chunk_ring.cuh", "pair_test.cuh", "stream_walk.cuh"]
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
                                  "chunk_ring.cuh", "stream_walk.cuh",
                                  "grid_walk.cu", "shade_pack.cu"])
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
    ("ntr_occluded_t_hbm", "_OCCLUDED_T_ARGS", "occluded_transparent.cu"),
    ("ntr_occluded_hbm_info", "_INFO_ARGS", "occluded.cu"),
    ("ntr_occluded_t_hbm_info", "_INFO_ARGS", "occluded_transparent.cu"),
    ("ntr_nearest_hit_hbm_info", "_NEAREST_INFO_ARGS", "nearest_hit.cu"),
    ("ntr_nearest_t_hbm_info", "_NEAREST_INFO_ARGS",
     "nearest_hit_transparent.cu"),
    ("ntr_nearest_t_info", "_NEAREST_INFO_ARGS",
     "nearest_hit_transparent.cu")])
def test_streaming_ctypes_signatures_match_the_c_entry_points(
        fn, argtypes, source):
    """The streaming walks (kernels 2.5-2.8) take their resident sibling's
    arguments, the launch queries of 2.6 and 2.8 a d and five ints, those
    of 2.5 and 2.7 a d, the shared flag and five ints, and load() binds
    them so."""
    _check_signature(fn, getattr(_build, argtypes), source)
    src = open(_build.__file__).read()
    assert f'("{fn}", {argtypes})' in src


@pytest.mark.parametrize("fn,argtypes", [
    ("ntr_grid_nearest_hit", "_GRID_NEAREST_ARGS"),
    ("ntr_grid_occluded", "_GRID_OCCLUDED_ARGS")])
def test_grid_ctypes_signatures_match_the_c_entry_points(fn, argtypes):
    """The grid walks for d > 8 (kernels 2.9 and 2.10, csrc/grid_walk.cu),
    bound by load() with these argtypes."""
    _check_signature(fn, getattr(_build, argtypes), "grid_walk.cu")
    src = open(_build.__file__).read()
    assert f"lib.{fn}.argtypes = {argtypes}" in src


def _grid_ds(src):
    """The d that grid_walk.cu's entries switch over (NTR_GRID_DS)."""
    listed = re.search(r"#define NTR_GRID_DS\(X\)(.*?)\n\n", src, re.S)
    return [int(x) for x in re.findall(r"X\((\d+)\)", listed.group(1))]


def _entry_body(src, entry):
    return re.search(r"int %s\(.*?\)\s*\{(.*?)\n\}" % entry, src,
                     re.S).group(1)


def test_grid_kernels_take_d_up_to_16():
    """The CUDA grid kernels' templates hold a ray's coordinates in
    registers, one instantiation for each d up to 16; every entry sends a
    larger d to the wide body (the switch's default, from WIDE_D = 17) and
    refuses d < 3, so the wrappers check only d >= 3.  The wide bodies
    launch with no dynamic shared memory: nothing of theirs grows with d,
    and no launch is refused for it."""
    from ntracer_tpu_torch.engine import grid_kernels as gk
    src = open(os.path.join(_build.CSRC_DIR, "grid_walk.cu")).read()
    assert max(_grid_ds(src)) == gk.WIDE_D - 1 == 16
    assert re.search(r"constexpr int WIDE_D = %d;" % gk.WIDE_D, src)
    for entry, wide in (
            ("ntr_grid_nearest_hit", "launch_wide_nearest<true>("),
            ("ntr_grid_nearest_hit_info", "wide_info(wide_nearest_kernel<"),
            ("ntr_grid_occluded", "launch_wide_occluded("),
            ("ntr_grid_occluded_info", "wide_info(wide_occluded_kernel,")):
        body = _entry_body(src, entry)
        assert "NTR_GRID_DS(NTR_CASE)" in body, entry
        default = body[body.index("default:"):]
        assert default.startswith("default:\n      if (d < WIDE_D) return "
                                  "(int)cudaErrorInvalidValue;"), entry
        assert wide in default, entry
    assert re.search(r"constexpr int TB = %d;" % gk.TRI_BLOCK, src)
    assert re.search(r"constexpr int RB = %d;" % gk.RAY_BLOCK, src)
    assert not hasattr(gk, "MAX_D")
    wide = src[src.index("// Kernels 2.9 and 2.10 past d = 16"):
               src.index("}  // namespace")]
    assert len(re.findall(r"wide_\w+_kernel(?:<SHARED>)?<<<R / RB, RB, 0, "
                          r"stream>>>", wide)) == 2
    for gone in ("wide_smem", "wide_config", "wide_stage", "StagedCol",
                 "extern __shared__"):
        assert gone not in wide, gone
    assert not hasattr(gk, "wide_shared_bytes")


def _defines(name, fn):
    """Whether csrc/``name`` defines the device function ``fn`` (a
    template or an inline function, not a call)."""
    src = open(os.path.join(_build.CSRC_DIR, name)).read()
    return re.search(r"__device__ __forceinline__ \w+ %s\(" % fn, src) \
        is not None


@pytest.mark.parametrize("fn", ["stream_walk", "pair_test_warp",
                                "entry_minima_t", "warp_cands"])
def test_one_streaming_loop_for_the_four_streaming_walks(fn):
    """The streaming walks' loop and its pieces are defined once, in
    stream_walk.cuh (chunk_ring.cuh keeps only the TMA and mbarrier
    primitives), and every streaming kernel (2.5-2.8) runs on it."""
    names = [os.path.basename(p) for p in _build.sources() +
             _build.headers()]
    assert [n for n in names if _defines(n, fn)] == ["stream_walk.cuh"]
    ring = open(os.path.join(_build.CSRC_DIR, "chunk_ring.cuh")).read()
    assert "ring_config" not in ring and "stream_walk(" not in ring
    for src in ("nearest_hit.cu", "occluded.cu", "nearest_hit_transparent.cu",
                "occluded_transparent.cu"):
        text = open(os.path.join(_build.CSRC_DIR, src)).read()
        assert '#include "stream_walk.cuh"' in text
        assert re.search(r"stream_walk<D, (true|false)(, N)?>\(", text), src


def test_filtered_occlusion_walks_share_the_streaming_body():
    """Kernel 2.4 runs 2.8's body on stream_walk.cuh: both C entries launch
    the one launcher of `occluded_t_stream_kernel`, and the resident body
    `occluded_t_kernel` is gone."""
    src = open(os.path.join(_build.CSRC_DIR, "occluded_transparent.cu")).read()
    assert "occluded_t_kernel" not in src
    assert "resident_walk" not in src and "pair_test<" not in src
    assert len(re.findall(r"__global__", src)) == 1
    for entry in ("ntr_occluded_t", "ntr_occluded_t_hbm"):
        body = re.search(r"int %s\(.*?\)\s*\{(.*?)\n\}" % entry, src, re.S)
        assert "return launch_stream_d(" in body.group(1), entry
    assert "occluded_t_stream_kernel<DD>" in src


def test_grid_nearest_launch_info_signature():
    """Kernel 2.9's launch query takes (d, shared, int[6]), bound by load()
    like the streaming walks' queries, and the wrapper names the six."""
    from ntracer_tpu_torch.engine import grid_kernels as gk
    _check_signature("ntr_grid_nearest_hit_info", _build._NEAREST_INFO_ARGS,
                     "grid_walk.cu")
    src = open(_build.__file__).read()
    assert '("ntr_grid_nearest_hit_info", _NEAREST_INFO_ARGS)' in src
    cu = open(os.path.join(_build.CSRC_DIR, "grid_walk.cu")).read()
    assert len(re.findall(r"info\[\d\] = ", cu)) == len(gk.GRID_INFO) == 6


def test_grid_nearest_kernel_instantiated_for_every_d():
    """2.9 is a template on D with no run-time d in its dots, switched at
    launch for every d = 3..16, both variants; a larger d reaches the wide
    body, both variants, whose dots loop to d (not over the padding)."""
    from ntracer_tpu_torch.engine import grid_kernels as gk
    src = open(os.path.join(_build.CSRC_DIR, "grid_walk.cu")).read()
    assert re.search(r"template <int D, bool SHARED, int RPT>\s*__global__ "
                     r"void __launch_bounds__\(RB / RPT\) grid_nearest_kernel",
                     src)
    listed = re.search(r"#define NTR_GRID_DS\(X\)(.*?)\n\n", src, re.S)
    ds = [int(x) for x in re.findall(r"X\((\d+)\)", listed.group(1))]
    assert ds == list(range(3, gk.WIDE_D))
    for entry in ("ntr_grid_nearest_hit", "ntr_grid_nearest_hit_info"):
        body = re.search(r"int %s\(.*?\)\s*\{(.*?)\n\}" % entry, src, re.S)
        assert "NTR_GRID_DS(NTR_CASE)" in body.group(1), entry
        assert "<DD, true>" in body.group(1) and "<DD, false>" in body.group(1)
        assert "wide_nearest_kernel<true>" in body.group(1) or \
            "launch_wide_nearest<true>" in body.group(1), entry
        assert "wide_nearest_kernel<false>" in body.group(1) or \
            "launch_wide_nearest<false>" in body.group(1), entry
    # the nearest-hit walk's dots run at the exact width: no `k < d` guard
    kernel = src[src.index("// Kernel 2.9: the nearest-hit grid walk"):
                 src.index("// Kernel 2.10: the occlusion grid walk")]
    assert "k < d" not in kernel and "MAXD" not in kernel
    assert "__any_sync" in kernel
    # the wide bodies take d at run time: their dots stop at d; both
    # variants run the one wide walk
    wide = src[src.index("// Kernels 2.9 and 2.10 past d = 16"):
               src.index("}  // namespace")]
    assert re.search(r"template <bool SHARED>\s*__global__ void "
                     r"__launch_bounds__\(RB(, \d)?\) wide_nearest_kernel",
                     wide)
    assert "if (k < d)" in wide and "int T, int R, int d," in wide
    kernel = wide[wide.index("wide_nearest_kernel("):]
    assert "wide_walk<SHARED, false>(" in kernel[:kernel.index("\n}")]


def test_grid_occluded_kernel_instantiated_for_every_d():
    """2.10 is a template on D (and rays a thread) with no run-time d,
    switched at launch for every d = 3..16; it reads the plane records
    `grec`, and the first port's run-time-d pieces are gone.  A larger d
    reaches the wide body, which reads `grec` too."""
    from ntracer_tpu_torch.engine import grid_kernels as gk
    src = open(os.path.join(_build.CSRC_DIR, "grid_walk.cu")).read()
    assert re.search(r"template <int D, int RPT>\s*__global__ void "
                     r"__launch_bounds__\(RB / RPT\) grid_occluded_kernel",
                     src)
    assert _grid_ds(src) == list(range(3, gk.WIDE_D))
    for entry in ("ntr_grid_occluded", "ntr_grid_occluded_info"):
        assert "<DD>" in _entry_body(src, entry) or \
            "<DD, OCCL_RAYS>" in _entry_body(src, entry), entry
        assert "wide_occluded" in _entry_body(src, entry), entry
    kernel = src[src.index("// Kernel 2.10: the occlusion grid walk"):
                 src.index("// Kernels 2.9 and 2.10 past d = 16")]
    assert "k < d" not in kernel and "__any_sync" in kernel
    assert re.search(r"const float\* __restrict__ grec", kernel)
    wide = src[re.search(r"__global__ void __launch_bounds__\(RB(, \d)?\) "
                         r"wide_occluded_kernel", src).start():
               src.index("}  // namespace")]
    assert re.search(r"const float\* __restrict__ grec", wide)
    assert "wide_walk<false, true>(" in wide[:wide.index("\n}")]
    for gone in (r"\bMAXD\b", r"\bSUB\b", r"struct Ray\b", r"\bload_ray\(",
                 r"\bstage\(", r"\btile_entry\("):
        assert not re.search(gone, src), gone


def test_grid_walks_share_one_pair_test_and_tile_loop():
    """Both grid kernels run one straight-line pair test (`grid_pair`, the
    sign pre-test and warp-uniform skips) in one tile loop (`grid_tiles`,
    the TMA ring): each is defined once and called by both kernels.  Past
    d = 16 both run one walk (`wide_walk`: the vote, the compaction of the
    live rays, the items and the merge) over one item loop (`wide_item`)
    and one pair test (`wide_pair`, with `wide_tail` for the last few
    lanes), each defined once."""
    src = open(os.path.join(_build.CSRC_DIR, "grid_walk.cu")).read()
    for fn in ("grid_pair", "grid_tiles"):
        assert len(re.findall(r"__device__ __forceinline__ \w+ %s\(" % fn,
                              src)) == 1, fn
    near = src[src.index("__global__ void __launch_bounds__(RB / RPT) "
                         "grid_nearest_kernel"):
               src.index("// Ring depth and dynamic shared memory")]
    occl = src[src.index("__global__ void __launch_bounds__(RB / RPT) "
                         "grid_occluded_kernel"):
               src.index("int launch_occluded")]
    for body in (near, occl):
        assert "grid_pair<D, " in body and "grid_tiles<D, RPT>(" in body
        assert "__syncthreads" not in body and "pair_test" not in body
    for fn in ("wide_walk", "wide_item", "wide_pair", "wide_tail",
               "wide_dots", "wide_entry"):
        assert len(re.findall(r"__device__ __forceinline__ \w+ %s\(" % fn,
                              src)) == 1, fn
    walk = src[src.index("__device__ __forceinline__ void wide_walk("):]
    walk = walk[:walk.index("\n}\n")]
    assert "wide_item<SHARED, OCCL>(" in walk and "wide_entry(" in walk
    assert walk.count("__syncthreads") >= 3


def test_grid_occluded_ctypes_signatures():
    """ntr_grid_occluded takes the plane records `grec` where it took the
    plane rows, and 2.10's launch query takes (d, int[6]), bound by load()
    like the streaming occlusion walks' queries."""
    from ntracer_tpu_torch.engine import grid_kernels as gk
    _check_signature("ntr_grid_occluded", _build._GRID_OCCLUDED_ARGS,
                     "grid_walk.cu")
    _check_signature("ntr_grid_occluded_info", _build._INFO_ARGS,
                     "grid_walk.cu")
    src = open(os.path.join(_build.CSRC_DIR, "grid_walk.cu")).read()
    params = re.search(r"int ntr_grid_occluded\((.*?)\)\s*\{", src,
                       re.S).group(1)
    assert "const float* grec" in params and " gt" not in params
    assert '("ntr_grid_occluded_info", _INFO_ARGS)' in \
        open(_build.__file__).read()
    body = _entry_body(src, "ntr_grid_occluded_info")
    assert "grid_info<DD, OCCL_RAYS>" in body
    assert len(gk.GRID_INFO) == 6


def test_nearest_walks_share_the_streaming_body():
    """Kernel 2.1 runs 2.5's body on stream_walk.cuh: both C entries launch
    the one launcher of `nearest_stream_kernel`, and the resident body
    `nearest_kernel` is gone."""
    src = open(os.path.join(_build.CSRC_DIR, "nearest_hit.cu")).read()
    assert not re.search(r"\bnearest_kernel\b", src)
    assert "resident_walk" not in src and "pair_test<" not in src
    assert len(re.findall(r"__global__", src)) == 1
    for entry in ("ntr_nearest_hit", "ntr_nearest_hit_hbm"):
        assert "return launch_stream_d(" in _entry_body(src, entry), entry
    assert "nearest_stream_kernel<D, SHARED>" in src
    from ntracer_tpu_torch.engine import resident_kernels as rk
    assert "ntr_nearest_hit" in rk._RING_ENTRIES
    assert rk._INFO_ENTRIES["nearest_hit"] == "ntr_nearest_hit_hbm_info"


def test_occlusion_walks_share_the_streaming_body():
    """Kernel 2.2 runs 2.6's body on stream_walk.cuh: both C entries launch
    the one launcher of `occluded_stream_kernel`, the resident body
    `occluded_kernel` is gone, the wrapper checks the ring's alignment and
    `stream_info("occluded", d)` reports the launch."""
    src = open(os.path.join(_build.CSRC_DIR, "occluded.cu")).read()
    assert not re.search(r"\boccluded_kernel\b", src)
    assert "resident_walk" not in src and "pair_test<" not in src
    assert len(re.findall(r"__global__", src)) == 1
    for entry in ("ntr_occluded", "ntr_occluded_hbm"):
        assert "return launch_stream_d(" in _entry_body(src, entry), entry
    assert "occluded_stream_kernel<DD>" in src
    from ntracer_tpu_torch.engine import resident_kernels as rk
    assert "ntr_occluded" in rk._RING_ENTRIES
    assert rk._INFO_ENTRIES["occluded"] == "ntr_occluded_hbm_info"


def test_transparent_walks_share_one_body_in_groups_of_one_and_four():
    """Kernel 2.3 runs 2.7's body on stream_walk.cuh in groups of one
    candidate (the TPU kernel's `_nearest_t_live` rule), 2.7 in groups of
    four: one `__global__` template on N, launched with N = 1 by
    `ntr_nearest_t` and N = NCAND by `ntr_nearest_t_hbm`, and the launch
    queries likewise; the resident body `nearest_t_kernel` is gone."""
    src = open(os.path.join(_build.CSRC_DIR,
                            "nearest_hit_transparent.cu")).read()
    assert not re.search(r"\bnearest_t_kernel\b", src)
    assert "resident_walk" not in src and "pair_test<" not in src
    assert len(re.findall(r"__global__", src)) == 1
    assert re.search(r"template <int D, bool SHARED, int N>\s*__global__ "
                     r"void __launch_bounds__\(RB, t_stream_blocks<D>\(\)\)"
                     r"\s*nearest_t_stream_kernel\(", src)
    assert "stream_walk<D, true, N>(" in src
    assert "stream_ring_config<D, true, N>(" in src
    for entry, n in (("ntr_nearest_t", "1"), ("ntr_nearest_t_hbm", "NCAND")):
        assert f"return launch_d<{n}>(" in _entry_body(src, entry), entry
    for entry, n in (("ntr_nearest_t_info", "1"),
                     ("ntr_nearest_t_hbm_info", "NCAND")):
        assert f"return info_d<{n}>(" in _entry_body(src, entry), entry
    from ntracer_tpu_torch.engine import resident_kernels as rk
    assert "ntr_nearest_t" in rk._RING_ENTRIES
    assert rk._INFO_ENTRIES["nearest_hit_transparent"] == \
        "ntr_nearest_t_info"
    assert '("ntr_nearest_t_info", _NEAREST_INFO_ARGS)' in \
        open(_build.__file__).read()


def test_ring_of_a_walk_in_groups_of_one_holds_two_slots():
    """The ring holds at most the chunks a walk knows, its group and the
    next one: `ring_max(N)` slots, which caps the ring's configuration and
    sizes the loop's barriers, so a walk in groups of one gets two."""
    ring = open(os.path.join(_build.CSRC_DIR, "chunk_ring.cuh")).read()
    walk = open(os.path.join(_build.CSRC_DIR, "stream_walk.cuh")).read()
    assert "constexpr int ring_max(int n) { return 2 * n; }" in ring
    assert "RING_MAX" not in ring + walk
    assert "if (s > ring_max(N)) s = ring_max(N);" in walk
    for arr in ("s_full", "s_empty", "s_next"):
        assert re.search(r"__shared__ \w+ %s\[ring_max\(N\)\];" % arr, walk)
    assert re.search(r"template <int D, bool OPA, int N = NCAND, class State",
                     walk)


@pytest.mark.parametrize("fn", ["resident_walk", "find_cands", "stage_chunk",
                                "stage_opacity", "block_max", "entry_minima",
                                "pair_test"])
def test_the_resident_loop_is_gone(fn):
    """No source or header of the CUDA library defines the resident walks'
    loop or its pieces any more: every chunk walk runs stream_walk.cuh's
    (`pair_test_warp`, `entry_minima_t`, `warp_cands`), and pair_test.cuh
    keeps only the ground they share."""
    for path in _build.sources() + _build.headers():
        src = open(path).read()
        assert not _defines(os.path.basename(path), fn), (path, fn)
        assert not re.search(r"\b%s(<[^<>]*>)?\(" % fn, src), (path, fn)
