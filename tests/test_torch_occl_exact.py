"""The two exactness arguments of the redesigned streaming occlusion walks
(kernels 2.6 and 2.8, csrc/occl_stream.cuh and csrc/occluded*.cu), held
here to the plain twin on the CPU; the kernels themselves are held to the
twin on the card (tests/test_torch_gpu.py).

* The split product: a visit's 128 factors, multiplied by the twin as a
  halving tree over the lanes, equal four aligned 32-position subtree
  products (positions in the bit-reversed lane order) combined as
  (T0 * T1) * (T2 * T3), each subtree kept only over its factors other
  than 1 by the kernel's short stack.
* The division's pre-test: a numerator and denominator that are not both
  nonzero, non-NaN and of one sign never pass the pair test's
  (dn != 0) and (num / dn > 0).
"""

import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (torch at one thread)
from ntracer_tpu_torch.engine import resident_kernels as prk

CK, SQ, SR = 128, 4, 32
F32 = np.float32


def range_lane(q, j):
    """The lane of position j of range q (occl_stream.cuh range_lane)."""
    brev5 = int(f"{j:05b}"[::-1], 2)
    return (brev5 << 2) | ((q & 1) << 1) | (q >> 1)


def brev7(p):
    return int(f"{p:07b}"[::-1], 2)


def range_product(factors, q):
    """The kernel's stack over range q's non-1 factors (tree_push and
    tree_close of occluded_transparent.cu), in float32."""
    st_, mask, cur, prev = [F32(1)] * 5, 0, F32(1), -1
    for j in range(SR):
        x = factors[range_lane(q, j)]
        if x == F32(1):
            continue
        if prev >= 0:
            h = (prev ^ j).bit_length() - 1
            for g in range(5):
                if g < h and (mask >> g) & 1:
                    cur = F32(st_[g] * cur)
            st_[h] = cur
            mask = (mask & ~((1 << h) - 1)) | (1 << h)
        cur, prev = x, j
    for g in range(5):
        if (mask >> g) & 1:
            cur = F32(st_[g] * cur)
    return cur


def split_product(factors):
    """(T0 * T1) * (T2 * T3), as the four lanes of a ray combine them."""
    t = [range_product(factors, q) for q in range(SQ)]
    return F32(F32(t[0] * t[1]) * F32(t[2] * t[3]))


def test_ranges_are_the_bit_reversed_subtrees():
    """Range q is positions 32q .. 32q + 31 of the bit-reversed lane order;
    at each step the four ranges read four consecutive lanes."""
    for q in range(SQ):
        assert [range_lane(q, j) for j in range(SR)] == \
            [brev7(SR * q + j) for j in range(SR)]
    for j in range(SR):
        lanes = sorted(range_lane(q, j) for q in range(SQ))
        assert lanes == list(range(lanes[0], lanes[0] + 4))
    assert sorted(range_lane(q, j) for q in range(SQ)
                  for j in range(SR)) == list(range(CK))


def _rows(seed, n_rows):
    """Factor rows of 128 with 0-128 entries other than 1: uniform, near 1,
    subnormal and tiny values, and (as glass gives) 1 - opacity."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n_rows):
        row = np.ones(CK, F32)
        k = int(rng.choice([0, 1, 2, 3, 5, 17, 64, 127, 128, i % 129]))
        pos = rng.choice(CK, k, replace=False)
        kind = i % 5
        if kind == 0:
            vals = rng.uniform(0, 1, k)
        elif kind == 1:                       # near 1, both sides
            vals = 1 + rng.randint(-40, 41, k) * np.finfo(F32).eps
        elif kind == 2:                       # subnormals and tiny values
            vals = rng.choice([1e-39, 3e-42, 1e-45, 1e-30, 0.5, 0.999], k)
        elif kind == 3:                       # 1 - opacity
            vals = 1 - rng.uniform(0.01, 0.99, k).astype(F32)
        else:                                 # wide range, some above 1
            vals = np.exp(rng.uniform(-20, 3, k))
        row[pos] = np.asarray(vals, F32)
        rows.append(row)
    return np.stack(rows)


@pytest.mark.parametrize("seed", range(4))
def test_split_product_equals_the_twins_halving_tree(seed):
    rows = _rows(seed, 150)
    tree = prk._lane_tree_product(torch.from_numpy(rows)).numpy()
    split = np.array([split_product(r) for r in rows], F32)
    assert np.array_equal(split.view(np.int32), tree.view(np.int32)), \
        np.nonzero(split.view(np.int32) != tree.view(np.int32))


def test_a_row_without_factors_is_one():
    row = np.ones(CK, F32)
    assert split_product(row) == F32(1)
    row[brev7(77)] = F32(0.25)
    assert split_product(row) == F32(0.25)


def passes_pretest(num, dn):
    """The kernel's pre-test before the division (pair_test_warp)."""
    return dn > 0 if num > 0 else (num < 0 and dn < 0)


# float32 values of every class the pre-test must sort: zeros of both signs,
# the smallest and largest subnormals, the smallest normal, values around 1,
# the largest finite value, infinities and NaNs of both signs
_SPECIAL = np.array(
    [0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, -1.1754942e-38,
     1.1754944e-38, -1.1754944e-38, 0.5, -0.5, 1.0, -1.0,
     1 - 2 ** -24, 1 + 2 ** -23, -(1 - 2 ** -24), -(1 + 2 ** -23),
     3.4028235e38, -3.4028235e38, np.inf, -np.inf], F32)
_NANS = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFBFFFFF],
                 np.uint32).view(F32)


@pytest.mark.parametrize("seed", range(4))
def test_a_rejected_pair_never_has_t_above_zero(seed):
    """Every pair of the special classes, and random bit patterns (every
    float32 class by its share of the encodings), both ways round."""
    vals = np.concatenate([_SPECIAL, _NANS])
    num, dn = (a.ravel() for a in np.meshgrid(vals, vals))
    pre = ((num > 0) & (dn > 0)) | ((num < 0) & (dn < 0))
    # the vectorized pre-test is the kernel's on every special pair
    assert pre.tolist() == [bool(passes_pretest(a, b))
                            for a, b in zip(num, dn)]
    n_rnd = 200000
    rnd = np.random.RandomState(seed).randint(
        0, 2 ** 32, size=(2, n_rnd), dtype=np.uint64).astype(np.uint32) \
        .view(F32)
    num = np.concatenate([num, rnd[0], rnd[0], np.resize(vals, n_rnd)])
    dn = np.concatenate([dn, rnd[1], np.resize(vals, n_rnd), rnd[1]])
    with np.errstate(all="ignore"):
        t = num / dn
    assert t.dtype == F32
    pre = ((num > 0) & (dn > 0)) | ((num < 0) & (dn < 0))
    assert n_rnd < pre.sum() < len(pre) - n_rnd      # both kinds occur
    # a zero dn fails dn != 0 (num / +-0 may be +inf); any other rejected
    # pair gives t = +-0, NaN or t < 0
    bad = ~pre & (dn != 0) & (t > 0)
    assert not bad.any(), (num[bad][:5], dn[bad][:5])
