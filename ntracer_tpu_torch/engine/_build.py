"""Build the CUDA kernels on first use and bind them with ctypes.

Every ``ntracer_tpu_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
process (all started together) and the objects are linked into one shared
library with a plain C interface, under ``build/ntracer_tpu_torch/`` beside
the package (where ``native.py`` builds the C++ k-d builder too).  The
library's name carries a hash of the flags and of every file the build
reads (the ``*.cu`` sources and the ``*.cuh`` headers they include), so an
edit rebuilds and a stale library is never loaded.

The flags keep IEEE float semantics: ``--fmad=false`` (no a*b+c
contraction: the pair test and the slab entry must round every operation,
as the plain twins do) and correctly rounded division and square root.
Fast math is never enabled.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from .. import tracing

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "ntracer_tpu_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# ntr_nearest_hit's C signature (csrc/nearest_hit.cu)
_NEAREST_ARGS = [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                 _I, _I, _I, _P, _P, _P, _P, _P]
# ntr_occluded's C signature (csrc/occluded.cu)
_OCCLUDED_ARGS = [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I,
                  _I, _I, _P, _P, _P, _P]
# ntr_nearest_t's C signature (csrc/nearest_hit_transparent.cu)
_NEAREST_T_ARGS = [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P]
# ntr_occluded_t's C signature (csrc/occluded_transparent.cu)
_OCCLUDED_T_ARGS = [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                    _I, _I, _I, _P, _P, _P, _P, _P]
# ntr_grid_nearest_hit's and ntr_grid_occluded's C signatures
# (csrc/grid_walk.cu)
_GRID_NEAREST_ARGS = [_P] * 9 + [_I, _I, _I, _I, _P, _P, _P, _P]
_GRID_OCCLUDED_ARGS = [_P] * 9 + [_I, _I, _I, _P, _P, _P]
# ntr_shade_pack's C signature (csrc/shade_pack.cu)
_SHADE_PACK_ARGS = [_P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _I,
                    _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _I,
                    _I, _I, _I, _P, _P]
# the launch queries: the chunk occlusion walks' (kernels 2.2/2.6 and
# 2.4/2.8) take (d, int[5]), the chunk nearest-hit walks' (2.1/2.5, 2.3 and
# 2.7) (d, shared, int[5]), the nearest-hit grid walk's (2.9) (d, shared,
# int[6]), the occlusion grid walk's (2.10) (d, int[6])
_INFO_ARGS = [_I, _P]
_NEAREST_INFO_ARGS = [_I, _I, _P]


def sources():
    """The CUDA sources, one ``nvcc`` compile each."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers():
    """The headers the sources include."""
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def find_nvcc():
    """``nvcc`` from PATH, else under CUDA_HOME or /usr/local/cuda."""
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def nvcc_command(src, obj, nvcc="nvcc"):
    """The compile command for one source ``src`` -> object ``obj``."""
    return [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]


def link_command(objs, out, nvcc="nvcc"):
    """The link command for ``objs`` -> shared library ``out``."""
    return [nvcc, "-shared", "-o", out, *objs]


def library_path():
    """The library's path: its name hashes the flags and every source and
    header under ``csrc/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources() + headers():
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    name = f"libntracer_kernels_{h.hexdigest()[:16]}.so"
    return os.path.join(BUILD_DIR, name)


def build():
    """Compile the kernels if needed; returns the library's path.  The
    compilers' output (ptxas register and shared-memory use) is kept in
    ``nvcc.log`` beside it."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out = library_path()
    if os.path.exists(out):
        return out
    with tracing.span("kernels.build"):
        return _build(srcs, out)


def _build(srcs, out):
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.path.basename(out)}.{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{tag}.{i}.o") for i in range(len(srcs))]
    cmds = [nvcc_command(s, o, nvcc) for s, o in zip(srcs, objs)]
    tmp = os.path.join(BUILD_DIR, f"{tag}.tmp")
    try:
        # one nvcc per source, all started together; then the link
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        runs = [(c, p.communicate()[0], p.returncode)
                for c, p in zip(cmds, procs)]
        if all(rc == 0 for _c, _text, rc in runs):
            cmd = link_command(objs, tmp, nvcc)
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            runs.append((cmd, proc.stdout, proc.returncode))
        with open(os.path.join(BUILD_DIR, "nvcc.log"), "w") as f:
            for cmd, text, _rc in runs:
                f.write(" ".join(cmd) + "\n" + text)
        for _cmd, text, rc in runs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{text}")
        os.replace(tmp, out)
    finally:
        for p in objs + [tmp]:
            if os.path.exists(p):
                os.remove(p)
    return out


def load():
    """The kernel library, built on first use (the span ``kernels.load``,
    its build ``kernels.build``)."""
    global _lib
    with _lock:
        if _lib is None:
            with tracing.span("kernels.load"):
                _lib = _load()
        return _lib


def _load():
    lib = ctypes.CDLL(build())
    lib.ntr_nearest_hit.argtypes = _NEAREST_ARGS
    lib.ntr_nearest_hit.restype = ctypes.c_int
    lib.ntr_occluded.argtypes = _OCCLUDED_ARGS
    lib.ntr_occluded.restype = ctypes.c_int
    lib.ntr_nearest_t.argtypes = _NEAREST_T_ARGS
    lib.ntr_nearest_t.restype = ctypes.c_int
    lib.ntr_nearest_t_hbm.argtypes = _NEAREST_T_ARGS
    lib.ntr_nearest_t_hbm.restype = ctypes.c_int
    lib.ntr_occluded_t.argtypes = _OCCLUDED_T_ARGS
    lib.ntr_occluded_t.restype = ctypes.c_int
    lib.ntr_grid_nearest_hit.argtypes = _GRID_NEAREST_ARGS
    lib.ntr_grid_nearest_hit.restype = ctypes.c_int
    lib.ntr_grid_occluded.argtypes = _GRID_OCCLUDED_ARGS
    lib.ntr_grid_occluded.restype = ctypes.c_int
    lib.ntr_shade_pack.argtypes = _SHADE_PACK_ARGS
    lib.ntr_shade_pack.restype = ctypes.c_int
    # the launch queries take a d (and the nearest-hit walks' shared
    # flag) and five or six ints
    queries = (
        ("ntr_nearest_hit_info", _NEAREST_INFO_ARGS),
        ("ntr_occluded_info", _INFO_ARGS),
        ("ntr_nearest_t_info", _NEAREST_INFO_ARGS),
        ("ntr_nearest_t_hbm_info", _NEAREST_INFO_ARGS),
        ("ntr_occluded_t_info", _INFO_ARGS),
        ("ntr_grid_nearest_hit_info", _NEAREST_INFO_ARGS),
        ("ntr_grid_occluded_info", _INFO_ARGS))
    for name, args in queries:
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    lib.ntr_error_string.argtypes = [ctypes.c_int]
    lib.ntr_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err):
    return load().ntr_error_string(err).decode()
