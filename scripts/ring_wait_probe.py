#!/usr/bin/env python3
"""Where the warps of kernel 2.3 (``ntr_nearest_t``: the streaming K-slot
walk in groups of one candidate) spend their cycles.

    python3 scripts/ring_wait_probe.py [CSRC_DIR]

Builds a copy of CSRC_DIR (default: this tree's ntracer_tpu_torch/csrc)
whose walk counts, per warp, with clock64(): the cycles from the first
group to the last (stream_walk.cuh), the cycles spent waiting on a ring
slot's "full" barrier (the chunk's TMA copies not landed yet), the cycles
spent in the group boundaries after the first (their block syncs, the
bound's reduction, the candidate pick), and the cycles of the tasks'
held-pair path in nearest_hit_transparent.cu (the lane-order retests, the
chunk's glass list and the offers to the K slots).  Then runs the kernel
once on each of torch_stream_ab.py's 2.3 wavefronts (the glass 120-cell's
primary and bounce rays, the "transparent d=3" primary rays, 1,048,576
rays each) and prints each count's share of the walk's cycles, with the
card's name and power limit.  The counters change no output: the script
checks the outputs against the unpatched library's.  Needs one CUDA card;
the port never imports it.
"""

import ctypes
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import torch_stream_ab as ab  # noqa: E402
from ntracer_tpu_torch.engine import _build  # noqa: E402
from ntracer_tpu_torch.engine import resident_kernels as rk  # noqa: E402

COUNTERS = r"""
// walk, full, boundary, held
static __device__ unsigned long long ntr_probe[4];
"""

READER = r"""
extern "C" int ntr_probe_read(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, ntr::ntr_probe, sizeof(
      unsigned long long) * 4);
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(ntr::ntr_probe, zero, sizeof(zero));
  return (int)err;
}
"""

# (text in stream_walk.cuh, its counted form)
PATCHES = [
    ("namespace ntr {\n\nconstexpr int SQ", "namespace ntr {\n" + COUNTERS +
     "\nconstexpr int SQ"),
    ("  boundary(true);\n  while (n_cur) {",
     "  boundary(true);\n  const long long p_t0 = clock64();\n"
     "  while (n_cur) {"),
    ("      mbar_wait(&s_full[s], (unsigned)(q / n_slots) & 1u);",
     "      const long long p_w0 = clock64();\n"
     "      mbar_wait(&s_full[s], (unsigned)(q / n_slots) & 1u);\n"
     "      if (lane == 0) atomicAdd(&ntr_probe[1], (unsigned long long)"
     "(clock64() - p_w0));"),
    ("    if (!n_cur) break;\n    boundary(false);",
     "    if (!n_cur) break;\n    const long long p_b0 = clock64();\n"
     "    boundary(false);\n"
     "    if (lane == 0) atomicAdd(&ntr_probe[2], (unsigned long long)"
     "(clock64() - p_b0));"),
    ("  __syncthreads();                     // the last group's tests are "
     "done\n  fold();\n  return base;",
     "  if (lane == 0) atomicAdd(&ntr_probe[0], (unsigned long long)"
     "(clock64() - p_t0));\n"
     "  __syncthreads();                     // the last group's tests are "
     "done\n  fold();\n  return base;"),
]


# (text in nearest_hit_transparent.cu, its counted form)
HELD_PATCHES = [
    ("      if (!__any_sync(FULL, held)) continue;",
     "      if (!__any_sync(FULL, held)) continue;\n"
     "      const long long p_h0 = clock64();"),
    ("        s_tmax[ray] = mx;\n      }\n",
     "        s_tmax[ray] = mx;\n      }\n"
     "      if (lane == 0) atomicAdd(&ntr_probe[3], (unsigned long long)"
     "(clock64() - p_h0));\n"),
]


def patch(path, patches):
    text = open(path).read()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{path} has no single {old[:40]!r}")
        text = text.replace(old, new)
    open(path, "w").write(text)


def patched_tree(csrc, out):
    """A copy of ``csrc`` with the counters in its walk loop."""
    shutil.copytree(csrc, out)
    patch(os.path.join(out, "stream_walk.cuh"), PATCHES)
    path = os.path.join(out, "nearest_hit_transparent.cu")
    patch(path, HELD_PATCHES)
    with open(path, "a") as f:
        f.write(READER)


def main():
    csrc = sys.argv[1] if len(sys.argv) > 1 else _build.CSRC_DIR
    if not torch.cuda.is_available():
        raise SystemExit("torch finds no CUDA device")
    card = cs.card()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        patched_tree(csrc, os.path.join(tmp, "probe"))
        trees = [("plain", csrc), ("probe", os.path.join(tmp, "probe"))]
        libs = ab.build(trees, ["2.3"], tmp)
        probe = libs["probe"][0]
        probe.ntr_probe_read.argtypes = [ctypes.c_void_p]
        probe.ntr_probe_read.restype = ctypes.c_int
        counts = (ctypes.c_ulonglong * 4)()
        cases = ab.transparent_cases(dev)
        for label, (_k, w) in cases.items():
            got = {}
            for name in ("plain", "probe"):
                _build._lib = libs[name][0]
                if name == "probe" and probe.ntr_probe_read(counts):
                    raise SystemExit("the counters cannot be read")
                err, got[name] = rk._nearest_kernel("ntr_nearest_t", w,
                                                    w["oT"].device)
                if err:
                    raise SystemExit(f"{name}: ntr_nearest_t failed ({err})")
            torch.cuda.synchronize()
            for a, b in zip(got["plain"], got["probe"]):
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                if not torch.equal(a, b):
                    raise SystemExit(f"the counters changed the outputs of "
                                     f"the {label}")
            if probe.ntr_probe_read(counts):
                raise SystemExit("the counters cannot be read")
            walk, full, bnd, held = (int(c) for c in counts)
            visits = int(got["plain"][-1].sum())
            print(f"2.3 {label}: {visits} visits, warps' walk cycles {walk}, "
                  f"waiting on a slot's copies {100 * full / walk:.2f}%, in "
                  f"group boundaries {100 * bnd / walk:.2f}%, on held pairs "
                  f"{100 * held / walk:.2f}% [{card}]")


if __name__ == "__main__":
    main()
