"""Small-dimension float32 linear algebra matching the reference semantics.

These are host-side (NumPy) ports of the n-dimensional vector/matrix
algorithms in the reference's geometry layer (src/geometry.hpp:
``decompose`` 629-665, ``inverse_`` 679-710, ``determinant_inplace`` 790-823,
``rotation_`` 577-591, ``cross_`` 858-906).  The loop orders are preserved so
float32 results match the C++ extension closely (bit-exactly where XLA/NumPy
round identically).  All of this is *build-time* math over (d,) and (d,d)
arrays with d typically 3..10 — Python loops are fine; the render-time math
lives in the torch engine (``ntracer_tpu_torch.engine``).
"""

from __future__ import annotations

import numpy as np

f32 = np.float32


def as_f32_vector(values, d: int | None = None) -> np.ndarray:
    a = np.asarray(values, dtype=f32).reshape(-1)
    if d is not None and a.shape[0] != d:
        raise TypeError(f"expected {d} values, got {a.shape[0]}")
    return a


def dot(a: np.ndarray, b: np.ndarray) -> np.float32:
    return f32(np.dot(a.astype(f32), b.astype(f32)))


def square(a: np.ndarray) -> np.float32:
    return dot(a, a)


def absolute(a: np.ndarray) -> np.float32:
    return f32(np.sqrt(square(a)))


def unit(a: np.ndarray) -> np.ndarray:
    return (a / absolute(a)).astype(f32)


def axis_vector(d: int, axis: int, length=1.0) -> np.ndarray:
    v = np.zeros(d, dtype=f32)
    v[axis] = f32(length)
    return v


def rotation_matrix(a: np.ndarray, b: np.ndarray, theta: float) -> np.ndarray:
    """Plane-of-rotation matrix from two (orthonormal) vectors.

    Matches geometry.hpp:577-591: given vector p, r*p equals
    dot(p,a)*(a*(cos-1) - b*sin) + dot(p,b)*(b*(cos-1) + a*sin) + p.
    """
    d = a.shape[0]
    c = f32(np.cos(theta) - 1.0)
    s = f32(np.sin(theta))
    r = np.empty((d, d), dtype=f32)
    for row in range(d):
        for col in range(d):
            x = a[row] * (a[col] * c - b[col] * s) + b[row] * (b[col] * c + a[col] * s)
            if col == row:
                x += f32(1)
            r[row, col] = x
    return r


def reflection_matrix(a: np.ndarray) -> np.ndarray:
    sq = square(a)
    d = a.shape[0]
    r = np.empty((d, d), dtype=f32)
    for row in range(d):
        for col in range(d):
            r[row, col] = (f32(1) if row == col else f32(0)) - f32(2) * a[row] * a[col] / sq
    return r


def scale_matrix_vec(a: np.ndarray) -> np.ndarray:
    return np.diag(a.astype(f32)).astype(f32)


def scale_matrix(d: int, a) -> np.ndarray:
    return (np.eye(d, dtype=f32) * f32(a)).astype(f32)


def decompose(m: np.ndarray):
    """Crout LU decomposition with partial pivoting (geometry.hpp:629-665).

    Returns ``(lu, pivots, swaps)`` with ``swaps == -1`` when singular.
    """
    d = m.shape[0]
    lu = np.zeros((d, d), dtype=f32)
    pivots = list(range(d))
    swapped = 0
    for j in range(d):
        for i in range(j, d):
            s = f32(0)
            for k in range(j):
                s += lu[i, k] * lu[k, j]
            lu[i, j] = m[pivots[i], j] - s

        alt_row = j
        alt_val = abs(lu[j, j])
        for i in range(j + 1, d):
            if abs(lu[i, j]) > alt_val:
                alt_row = i
                alt_val = abs(lu[i, j])
        if alt_row != j:
            pivots[alt_row], pivots[j] = pivots[j], pivots[alt_row]
            swapped += 1
            for i in range(j + 1):
                lu[alt_row, i], lu[j, i] = lu[j, i], lu[alt_row, i]
        elif alt_val == 0:
            return lu, pivots, -1

        for i in range(j + 1, d):
            s = f32(0)
            for k in range(j):
                s += lu[j, k] * lu[k, i]
            lu[j, i] = (m[pivots[j], i] - s) / lu[j, j]
    return lu, pivots, swapped


def determinant(m: np.ndarray) -> np.float32:
    lu, _, swapped = decompose(m)
    if swapped < 0:
        return f32(0)
    r = f32(-1) if swapped % 2 else f32(1)
    for i in range(m.shape[0]):
        r *= lu[i, i]
    return r


def determinant_inplace(m: np.ndarray) -> np.float32:
    """In-place determinant used by the generalized cross product
    (geometry.hpp:790-823).  ``m`` is destroyed."""
    d = m.shape[0]
    swapped = 0
    for j in range(d):
        for i in range(j, d):
            s = f32(0)
            for k in range(j):
                s += m[i, k] * m[k, j]
            m[i, j] = m[i, j] - s

        alt_row = j
        alt_val = abs(m[j, j])
        for i in range(j + 1, d):
            if abs(m[i, j]) > alt_val:
                alt_row = i
                alt_val = abs(m[i, j])
        if alt_row != j:
            swapped += 1
            tmp = m[alt_row].copy()
            m[alt_row] = m[j]
            m[j] = tmp
        elif alt_val == 0:
            return f32(0)

        for i in range(j + 1, d):
            s = f32(0)
            for k in range(j):
                s += m[j, k] * m[k, i]
            m[j, i] = (m[j, i] - s) / m[j, j]

    r = f32(-1) if swapped % 2 else f32(1)
    for i in range(d):
        r *= m[i, i]
    return r


def inverse(m: np.ndarray) -> np.ndarray:
    """Matrix inverse via Crout LU + fwd/back substitution (geometry.hpp:679-710)."""
    d = m.shape[0]
    tmp, pivots, swapped = decompose(m)
    if swapped < 0:
        raise ValueError("matrix is singular (uninvertible)")

    inv = np.zeros((d, d), dtype=f32)
    # forward substitution into the lower triangle of tmp
    for c in range(d):
        tmp[c, c] = f32(1) / tmp[c, c]
        for r in range(c + 1, d):
            s = f32(0)
            for i in range(c, r):
                s -= tmp[r, i] * tmp[i, c]
            tmp[r, c] = s / tmp[r, r]

    # back substitution
    for c in range(d):
        pc = pivots[c]
        inv[d - 1, pc] = tmp[d - 1, c]
        for r in range(d - 2, -1, -1):
            s = tmp[r, c] if r >= c else f32(0)
            for i in range(r + 1, d):
                s -= tmp[r, i] * inv[i, pc]
            inv[r, pc] = s
    return inv


def cross(vs: np.ndarray) -> np.ndarray:
    """Generalized cross product: (d-1, d) array of vectors -> (d,) vector
    perpendicular to all of them (geometry.hpp:858-906), via cofactor
    determinants of (d-1)x(d-1) minors."""
    vs = np.asarray(vs, dtype=f32)
    d = vs.shape[1]
    if vs.shape[0] != d - 1:
        raise TypeError(f"cross product of a {d}-dimensional space requires {d-1} vectors")
    r = np.empty(d, dtype=f32)
    fsign = f32(1) if d % 2 else f32(-1)
    tmp = np.empty((d - 1, d - 1), dtype=f32)
    for i in range(d):
        # minor skipping column i; tmp[k][j] = vs[j][k] (note the transpose,
        # matching impl::cross_'s vs(j,k) indexing)
        for j in range(d - 1):
            for k in range(i):
                tmp[k, j] = vs[j, k]
            for k in range(i + 1, d):
                tmp[k - 1, j] = vs[j, k]
        r[i] = fsign * determinant_inplace(tmp)
        fsign = -fsign
    return r


def gram_schmidt_normalize(t_orientation: np.ndarray) -> np.ndarray:
    """Camera re-orthonormalization (camera.hpp:25-36)."""
    d = t_orientation.shape[0]
    t = t_orientation.astype(f32).copy()
    new_axes = []
    for i in range(d - 1):
        x = np.zeros(d, dtype=f32)
        for j in range(i):
            x += dot(t[i + 1], t[j]) * t[j]
        new_axes.append(t[i + 1] - x)
    t[0] = t[0] / absolute(t[0])
    for i in range(1, d):
        t[i] = unit(new_axes[i - 1])
    return t


def batched_determinant_inplace(m: np.ndarray) -> np.ndarray:
    """Vectorized ``determinant_inplace`` over a leading batch axis:
    (N, d, d) float32 -> (N,) float32, bit-identical per element to the
    scalar routine (same Crout elimination, same strictly-greater partial
    pivoting, every f32 operation applied in the same order — the batch
    axis only vectorizes across independent matrices).  ``m`` is
    destroyed."""
    n, d, _ = m.shape
    swapped = np.zeros(n, np.int64)
    zero = np.zeros(n, bool)
    ar = np.arange(n)
    with np.errstate(divide="ignore", invalid="ignore"):
        for j in range(d):
            for i in range(j, d):
                s = np.zeros(n, dtype=f32)
                for k in range(j):
                    s = s + m[:, i, k] * m[:, k, j]
                m[:, i, j] = m[:, i, j] - s

            alt_row = np.full(n, j)
            alt_val = np.abs(m[:, j, j])
            for i in range(j + 1, d):
                v = np.abs(m[:, i, j])
                take = v > alt_val
                alt_row = np.where(take, i, alt_row)
                alt_val = np.where(take, v, alt_val)
            need = alt_row != j
            swapped += need
            other = m[ar, alt_row].copy()           # (n, d)
            row_j = m[:, j].copy()
            m[ar, alt_row] = np.where(need[:, None], row_j, other)
            m[:, j] = np.where(need[:, None], other, row_j)
            zero |= ~need & (alt_val == 0)

            for i in range(j + 1, d):
                s = np.zeros(n, dtype=f32)
                for k in range(j):
                    s = s + m[:, j, k] * m[:, k, i]
                m[:, j, i] = (m[:, j, i] - s) / m[:, j, j]

    r = np.where(swapped % 2 == 1, f32(-1), f32(1)).astype(f32)
    for i in range(d):
        r = r * m[:, i, i]
    return np.where(zero, f32(0), r).astype(f32)


def batched_cross(vs: np.ndarray) -> np.ndarray:
    """Vectorized generalized cross: (N, d-1, d) -> (N, d), bit-identical
    per row to ``cross`` (same minors, same in-place Crout determinant)."""
    vs = np.asarray(vs, dtype=f32)
    n, rows, d = vs.shape
    if rows != d - 1:
        raise TypeError(
            f"cross product of a {d}-dimensional space requires {d-1} vectors")
    r = np.empty((n, d), dtype=f32)
    fsign = f32(1) if d % 2 else f32(-1)
    for i in range(d):
        # minor skipping column i; tmp[:, k, j] = vs[:, j, k] (transposed,
        # matching the scalar routine)
        cols = [k for k in range(d) if k != i]
        tmp = vs[:, :, cols].transpose(0, 2, 1).copy()   # (n, d-1, d-1)
        r[:, i] = fsign * batched_determinant_inplace(tmp)
        fsign = -fsign
    return r
