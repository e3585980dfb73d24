"""The exactness arguments of the redesigned streaming nearest-hit walks
(kernels 2.5 and 2.7, and 2.1 and 2.3, which launch their bodies;
csrc/nearest_hit.cu, csrc/nearest_hit_transparent.cu and
csrc/stream_walk.cuh), held here to the plain twins' rules on the CPU in
float32 numpy; the kernels themselves are held to the twins on the card
(tests/test_torch_gpu.py).

* The range merge: a ray's 128 slots split into four ranges (lanes q,
  q + 4, ...), each range's first minimum of t, merged as the lexicographic
  minimum of (t, lane), is the first minimum of the 128-lane scan.
* The glass list: the four ranges' glass pairs as bit masks, gathered and
  inserted in lane order behind every entry <= t, give the chunk's nearest
  8 in the twin's order (t, then lane), and offered to the K slots they
  leave the slots as the twin's ``_insert_transparent`` does.
* The cuts: an opaque pair at or beyond the ray's best, a glass pair at or
  beyond its largest slot, changes nothing, so leaving them out is exact.
* The fold: 2.5's per-visit minima, folded in any order into one key of
  (t's bits, visit, lane) by atomicMin, give the sequential walk's best and
  slot; 2.7's visits, run in walk order, give its slots.
* The shared pre-test: with the offset rows holding the origin dots the
  numerator is the row value itself, and the pre-test before the division
  rejects no pair that pair_test keeps.
* The live set of 2.7: a ray with a coordinate that is not finite has no
  valid pair, so the walk need not list it.
"""

import numpy as np
import pytest
import torch

import _torch_helpers  # noqa: F401  (torch at one thread)
from ntracer_tpu_torch.engine import resident_kernels as prk

CK, SQ, SR, KMAX = 128, 4, 32, 8
F32 = np.float32
INF = F32(np.inf)


def _chunks(seed, n):
    """``n`` chunks of 128 (t, valid, opaque) for one ray: t from a few
    values (so ties fall across lanes), infinities, NaNs, negatives and
    zeros; valid as the pair test would leave it (t > 0 and not NaN) and
    at random; opaque slots at random."""
    rng = np.random.RandomState(seed)
    t = rng.choice(np.array([0.5, 0.75, 1.0, 1.25, 2.0, 3.5], F32), (n, CK))
    t = np.where(rng.rand(n, CK) < 0.5,
                 rng.uniform(0.1, 4, (n, CK)).astype(F32), t)
    special = rng.rand(n, CK)
    t[special < 0.03] = INF
    t[(special >= 0.03) & (special < 0.06)] = np.nan
    t[(special >= 0.06) & (special < 0.08)] = F32(-1)
    t[(special >= 0.08) & (special < 0.09)] = F32(0)
    with np.errstate(invalid="ignore"):
        valid = (t > 0) & (rng.rand(n, CK) < rng.uniform(0.02, 0.9, (n, 1)))
    opaque = rng.rand(n, CK) < rng.uniform(0, 1, (n, 1))
    return t, valid, opaque


def scan_first_min(t, valid, cut=INF):
    """The resident kernels' lane loop: strict <, lanes in order, below
    ``cut``: (t, lane), (INF, 0) without a hit."""
    best, arg = INF, 0
    for lane in range(CK):
        if valid[lane] and t[lane] < best and t[lane] < cut:
            best, arg = t[lane], lane
    return best, arg


def range_merge(t, valid, cut):
    """2.5's rule: range q takes lanes q, q + 4, ... with a running cut at
    its own nearest hit, then the lexicographic (t, lane) minimum of the
    four.  (INF, CK) without a hit."""
    got = []
    for q in range(SQ):
        bt, bl = INF, CK
        for j in range(SR):
            lane = SQ * j + q
            c = bt if bt < cut else cut
            if valid[lane] and t[lane] > 0 and t[lane] < c:
                bt, bl = t[lane], lane
        got.append((bt, bl))
    for off in (1, 2):                 # the two shuffles
        got = [min(got[q], got[q ^ off]) for q in range(SQ)]
    assert all(g == got[0] for g in got)
    return got[0]


@pytest.mark.parametrize("seed", range(3))
def test_range_minima_merged_are_the_lane_scan(seed):
    t, valid, _opaque = _chunks(seed, 400)
    tm = torch.from_numpy(np.where(valid, t, INF))
    twin_t, twin_arg = torch.min(tm, dim=1)       # the twin's chunk minimum
    for i in range(t.shape[0]):
        for cut in (INF, F32(1.0), F32(0.75), F32(np.nan), F32(0)):
            want = scan_first_min(t[i], valid[i], cut)
            bt, bl = range_merge(t[i], valid[i], cut)
            if want[0] < INF:
                assert (bt, bl) == want, (i, cut)
            else:
                assert bl == CK
        if twin_t[i] < INF:
            assert (F32(twin_t[i]), int(twin_arg[i])) == \
                scan_first_min(t[i], valid[i])


def glass_list(t, valid, opaque, cut):
    """2.7's glass step for one chunk: each range's mask of glass pairs
    below ``cut``, gathered and inserted in lane order behind every entry
    <= t (the last falls off): the chunk's nearest KMAX (t, lane)."""
    masks = [0] * SQ
    for q in range(SQ):
        for j in range(SR):
            lane = SQ * j + q
            if valid[lane] and not opaque[lane] and t[lane] < cut:
                masks[q] |= 1 << j
    ct, cl = [INF] * KMAX, [0] * KMAX
    for j in range(SR):
        for p in range(SQ):
            if not (masks[p] >> j) & 1:
                continue
            x, xl, moved = t[SQ * j + p], SQ * j + p, False
            for i in range(KMAX):
                if moved or x < ct[i]:
                    ct[i], cl[i], x, xl = x, xl, ct[i], cl[i]
                    moved = True
    return ct, cl


def offer(tt, ts, ct, cl, K, base):
    """Offer the chunk's K nearest to the slots, nearest first, each
    replacing the FIRST largest slot when it is nearer (slots past K hold
    -inf).  Returns the new slots and their largest."""
    tt, ts = list(tt), list(ts)
    for j in range(K):
        if ct[j] < INF:
            barg = int(np.argmax(tt))            # the first largest
            if ct[j] < tt[barg]:
                tt[barg], ts[barg] = ct[j], base + cl[j]
    return tt, ts, max(tt)


@pytest.mark.parametrize("K", [1, 2, 8])
def test_glass_masks_sorted_in_lane_order_equal_the_twins_insertion(K):
    """Over a walk of chunks (slots starting at +inf), 2.7's step -- masks
    below the largest slot, the lane-order list, the offer -- leaves the K
    slots as ``_insert_transparent`` does with every glass pair."""
    t, valid, opaque = _chunks(10 + K, 300)
    tt = [INF] * K + [-INF] * (KMAX - K)
    ts = [-1] * KMAX
    tmax = INF
    twin_tt = torch.full((1, 1, K), float("inf"))
    twin_ts = torch.full((1, 1, K), -1, dtype=torch.int64)
    for i in range(t.shape[0]):
        ct, cl = glass_list(t[i], valid[i], opaque[i], tmax)
        tt, ts, tmax = offer(tt, ts, ct, cl, K, i * CK)
        tmt = torch.from_numpy(np.where(valid[i] & ~opaque[i], t[i], INF))
        twin_tt, twin_ts = prk._insert_transparent(
            twin_tt, twin_ts, tmt[None, None, :],
            torch.tensor([[i * CK]]), K)
        assert np.array_equal(np.array(tt[:K], F32),
                              twin_tt[0, 0].numpy()), i
        assert ts[:K] == twin_ts[0, 0].tolist(), i


def test_the_lane_order_list_is_the_chunks_nearest_eight():
    t, valid, opaque = _chunks(21, 300)
    for i in range(t.shape[0]):
        ct, cl = glass_list(t[i], valid[i], opaque[i], INF)
        pairs = sorted((float(t[i][l]), l) for l in range(CK)
                       if valid[i][l] and not opaque[i][l] and t[i][l] < INF)
        pairs = (pairs + [(float(INF), 0)] * KMAX)[:KMAX]
        got = [(float(a), b if a < INF else 0) for a, b in zip(ct, cl)]
        assert got == [(a, b if a < INF else 0) for a, b in pairs], i


def sequential(ts_, valids, opaques, best, idxs):
    """The twins' opaque rule over a group's visits in order: the chunk's
    first minimum, taken when strictly below best."""
    bid = -1
    for t, valid, opq, idx in zip(ts_, valids, opaques, idxs):
        ct, carg = scan_first_min(t, valid & opq)
        if ct < best:
            best, bid = ct, idx * CK + carg
    return best, bid


def key_fold(ts_, valids, opaques, best, idxs, order):
    """2.5's rule: each visit's range-merged minimum below the boundary's
    best, folded by atomicMin into one key (t's bits, visit, lane) in the
    tasks' ``order``; the boundary decodes it."""
    key = (1 << 64) - 1
    for v in order:
        bt, bl = range_merge(ts_[v], valids[v] & opaques[v], best)
        if bl < CK:
            k = (int(np.array(bt, F32).view(np.uint32)) << 32) | (v << 8) | bl
            key = min(key, k)
    if key == (1 << 64) - 1:
        return best, None
    t = np.array(key >> 32, np.uint32).view(F32)
    return t, idxs[(key >> 8) & 0xff] * CK + (key & 0xff)


@pytest.mark.parametrize("seed", range(3))
def test_visit_minima_folded_in_any_order_equal_the_sequential_walk(seed):
    """Groups of four visits, ties across visits forced (the same chunk
    visited twice in a group), every order of the visits' tasks."""
    rng = np.random.RandomState(seed)
    t, valid, opaque = _chunks(30 + seed, 240)
    for g in range(0, 240, 4):
        ts_, vs, os_ = list(t[g:g + 4]), list(valid[g:g + 4]), \
            list(opaque[g:g + 4])
        if g % 8 == 0:                 # a tie across two visits
            ts_[2], vs[2], os_[2] = ts_[1], vs[1], os_[1]
        idxs = list(rng.permutation(1000)[:4])
        for best in (INF, F32(1.0), F32(0.6), F32(np.nan), F32(0)):
            want_t, want_id = sequential(ts_, vs, os_, best, idxs)
            for order in ([0, 1, 2, 3], [3, 2, 1, 0], [2, 0, 3, 1]):
                got_t, got_id = key_fold(ts_, vs, os_, best, idxs, order)
                if got_id is None:
                    assert want_id == -1 and (
                        want_t == best or (np.isnan(want_t)
                                           and np.isnan(best)))
                else:
                    assert (got_t, got_id) == (want_t, want_id)


def test_positive_float_bits_order_as_the_floats():
    """The key's high word: t > 0 (finite), so its bits as an unsigned
    order as t does, ties included."""
    rng = np.random.RandomState(4)
    t = np.concatenate([rng.uniform(0, 10, 5000).astype(F32),
                        np.array([1e-45, 1.1754942e-38, 1.1754944e-38,
                                  3.4028235e38, 0.5, 0.5], F32)])
    t = t[t > 0]
    bits = t.view(np.uint32).astype(np.int64)
    o = np.argsort(t, kind="stable")
    assert np.all(np.diff(bits[o]) >= 0)
    assert np.array_equal(np.sign(np.subtract.outer(bits, bits)),
                          np.sign(np.subtract.outer(t.astype(np.float64),
                                                    t.astype(np.float64))))


@pytest.mark.parametrize("K", [2, 8])
def test_glass_cut_at_the_largest_slot_changes_nothing(K):
    """Leaving out the glass pairs at or beyond the largest slot (held at
    the visit's start) gives the slots of offering every pair."""
    t, valid, opaque = _chunks(50 + K, 300)
    tt_cut = tt_all = [INF] * K + [-INF] * (KMAX - K)
    ts_cut = ts_all = [-1] * KMAX
    tmax = INF
    for i in range(t.shape[0]):
        ct, cl = glass_list(t[i], valid[i], opaque[i], tmax)
        tt_cut, ts_cut, tmax = offer(tt_cut, ts_cut, ct, cl, K, i * CK)
        ct, cl = glass_list(t[i], valid[i], opaque[i], INF)
        tt_all, ts_all, _m = offer(tt_all, ts_all, ct, cl, K, i * CK)
        assert tt_cut == tt_all and ts_cut == ts_all, i


def test_opaque_cut_at_best_changes_nothing():
    t, valid, opaque = _chunks(60, 300)
    best_cut = best_all = F32(3.0)
    id_cut = id_all = -1
    for i in range(t.shape[0]):
        ct, carg = scan_first_min(t[i], valid[i] & opaque[i])
        if ct < best_all:
            best_all, id_all = ct, i * CK + carg
        bt, bl = range_merge(t[i], valid[i] & opaque[i], best_cut)
        if bl < CK:
            assert bt < best_cut
            best_cut, id_cut = bt, i * CK + bl
        assert (best_cut, id_cut) == (best_all, id_all), i


# float32 values of every class: zeros of both signs, the smallest and
# largest subnormals, the smallest normal, values around 1, the largest
# finite value, infinities and NaNs
_SPECIAL = np.array(
    [0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, -1.1754942e-38,
     1.1754944e-38, -1.1754944e-38, 0.5, -0.5, 1.0, -1.0,
     1 - 2 ** -24, 1 + 2 ** -23, 3.4028235e38, -3.4028235e38, np.inf,
     -np.inf, np.nan, -np.nan], F32)


@pytest.mark.parametrize("d", [3, 6, 8])
def test_shared_pretest_rejects_no_kept_pair(d):
    """Shared rows: num = s_c[l], dn = sum_k dv_k * g_k summed from the
    first product (pair_test_warp) or from +0 (pair_test).  The two dn
    differ at most in the sign of a zero; where the pre-test (num, dn
    nonzero, not NaN, of one sign) passes, t = num / dn is bit-equal; where
    it fails, pair_test's (dn != 0) and (t > 0) fails too."""
    rng = np.random.RandomState(d)
    n = 60000
    g = rng.normal(size=(n, d)).astype(F32)
    dv = rng.normal(size=(n, d)).astype(F32)
    num = rng.normal(size=n).astype(F32)
    # special values in every slot of the sweep
    for a in (g, dv):
        m = rng.rand(*a.shape) < 0.08
        a[m] = rng.choice(_SPECIAL, int(m.sum()))
    g[rng.rand(n) < 0.05] = 0
    dv[rng.rand(n) < 0.05] = 0
    m = rng.rand(n) < 0.2
    num[m] = rng.choice(_SPECIAL, int(m.sum()))
    with np.errstate(all="ignore"):
        dn_first = dv[:, 0] * g[:, 0]
        dn_zero = F32(0) + dv[:, 0] * g[:, 0]
        for k in range(1, d):
            dn_first = dn_first + dv[:, k] * g[:, k]
            dn_zero = dn_zero + dv[:, k] * g[:, k]
        assert dn_first.dtype == F32 and dn_zero.dtype == F32
        same = (dn_first.view(np.int32) == dn_zero.view(np.int32)) \
            | ((dn_first == 0) & (dn_zero == 0)) \
            | (np.isnan(dn_first) & np.isnan(dn_zero))
        assert same.all()
        pre = ((num > 0) & (dn_first > 0)) | ((num < 0) & (dn_first < 0))
        t_first = num / np.where(pre, dn_first, F32(1))
        t_zero = num / dn_zero
        kept = (dn_zero != 0) & (t_zero > 0)
    assert 0 < pre.sum() < n
    assert not (kept & ~pre).any()
    assert np.array_equal(t_first[pre].view(np.int32),
                          t_zero[pre].view(np.int32))


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("d", [3, 6])
def test_a_ray_with_a_coordinate_not_finite_has_no_valid_pair(d, shared):
    """2.7 lists only rays whose direction (and, without the shared rows,
    origin) is finite: the twin's pair test finds no valid pair for any
    other ray, on random chunks."""
    rng = np.random.RandomState(70 + d)
    n, R = 6, 64
    pr = -(-d * d // 8) * 8
    g = rng.normal(size=(n, pr, CK)).astype(F32)
    ci = rng.uniform(-1, 2, (n, 8, CK)).astype(F32)
    # half the chunks with flat edge rows (every edge value 1 / d): there
    # a finite ray's pair is valid whenever 0 < t
    g[::2, d:] = 0
    ci[::2, 1:d] = F32(1.0 / d)
    g, ci = torch.from_numpy(g), torch.from_numpy(ci)
    ids = torch.from_numpy(rng.randint(0, 1000, (n, CK)).astype(np.int32))
    o = rng.normal(size=(d, n, R, 1)).astype(F32)
    dv = rng.normal(size=(d, n, R, 1)).astype(F32)
    bad = np.array([np.inf, -np.inf, np.nan], F32)
    for r in range(R):
        k = r % d
        target = dv if shared or r % 2 else o
        target[k, :, r] = bad[r % 3]
    skip = torch.full((n, R, 1), -1, dtype=torch.int32)
    t, valid = prk._chunk_hits_vals(d, shared, g, ci, ids,
                                    torch.from_numpy(o), torch.from_numpy(dv),
                                    skip)
    assert not bool(valid.any())
    # the same rays made finite do hit: the check has teeth
    o2 = np.nan_to_num(o, nan=0.1, posinf=0.2, neginf=-0.2)
    dv2 = np.nan_to_num(dv, nan=0.3, posinf=0.4, neginf=-0.4)
    t, valid = prk._chunk_hits_vals(d, shared, g, ci, ids,
                                    torch.from_numpy(o2),
                                    torch.from_numpy(dv2), skip)
    assert bool(valid.any())
