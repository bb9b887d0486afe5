"""Compensated (double-single) summation primitives.

Why this exists: the reference computes losses in float64 and stops on
relative loss deltas as small as 1e-10 (src/optimize.cpp:381-408).  The
factors and data are float32 (float64 runs at a small fraction of the f32
rate on GPUs), and a naive f32 sum over ~1e7
squared residuals carries ~1e-5 relative error — the stopping rule would be
noise.  We recover float64-grade accuracy from pure f32 arithmetic with
error-free transformations:

  * ``two_sum``  — Knuth's exact addition: a+b = s + e exactly.
  * ``two_prod`` — Dekker's exact product via 2^12+1 splitting (no FMA needed).
  * a fully-vectorized pairwise-TwoSum tree: fold contiguous halves with
    two_sum, carrying an error vector that plain-sums the (tiny) residuals.

Total error is O(n * eps^2) relative (~1e-8 even at n=1e9) — matching naive
float64 accumulation.  All ops are elementwise and cost ~2 passes over the
data; every tree level is one wide vector op, so the depth is log2(n) fused
steps rather than a sequential carry.  Host-side finalization adds hi+lo in
python float64.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# Lane width of the tree's leaf level.  The flat input is reshaped to
# (G, LANES) (one tiny pad), the tree first folds the G axis, then the lane
# axis — padding never exceeds LANES + next_pow2(G) elements, independent of n.
_LANES = 1 << 15


def two_sum(a, b):
    """Error-free addition: returns (s, e) with s = fl(a+b), a+b = s+e exactly."""
    s = a + b
    bv = s - a
    av = s - bv
    e = (a - av) + (b - bv)
    return s, e


def _split(a):
    """Dekker split of an f32 value into hi+lo with 12/12 bit halves."""
    c = jnp.float32(4097.0) * a  # 2**12 + 1
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free product: returns (p, e) with p = fl(a*b), a*b = p+e exactly."""
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def ds_add(ahi, alo, bhi, blo):
    """Double-single addition (Dekker add2): (ahi+alo) + (bhi+blo) as a
    renormalized (hi, lo) pair, error O(eps^2) relative per op."""
    s, e = two_sum(ahi, bhi)
    e = e + (alo + blo)
    return two_sum(s, e)


def _tree_fold(hi, lo, axis: int):
    """Pairwise double-single tree along `axis` (length a power of two).
    Every level is one wide vector op — no sequential carry — and each fold
    is a full ds_add, so the error channel keeps O(eps^2) accuracy all the
    way to the root (plain-adding the residuals loses ~eps·log n near the
    top, where they are O(eps·total))."""
    while hi.shape[axis] > 1:
        h = hi.shape[axis] // 2
        hi, lo = ds_add(
            lax.slice_in_dim(hi, 0, h, axis=axis),
            lax.slice_in_dim(lo, 0, h, axis=axis),
            lax.slice_in_dim(hi, h, 2 * h, axis=axis),
            lax.slice_in_dim(lo, h, 2 * h, axis=axis),
        )
    return hi, lo


def _compensated_reduce(x, square: bool):
    """Sum (or sum of squares) of all elements of x with ~f64 accuracy.

    Reshape to (G, LANES) (pad < LANES), take the elementwise exact squares,
    then TwoSum-tree-fold the G axis followed by the lane axis.  All levels
    are contiguous-half folds: vectorized, fusion-friendly, ~2 passes of HBM
    traffic total.
    """
    flat = x.reshape(-1).astype(jnp.float32)
    n = flat.shape[0]
    L = _LANES if n > _LANES else max(1, 1 << (n - 1).bit_length())
    G = -(-n // L)
    Gp = 1 << (G - 1).bit_length()          # pad G up to a power of two
    if Gp * L != n:
        flat = jnp.pad(flat, (0, Gp * L - n))
    grid = flat.reshape(Gp, L)

    if square:
        s, c = two_prod(grid, grid)
    else:
        s, c = grid, jnp.zeros_like(grid)
    s, c = _tree_fold(s, c, axis=0)
    s, c = _tree_fold(s, c, axis=1)
    return s[0, 0], c[0, 0]


def sum_squares_ds(x):
    """Compensated sum of squares of all elements. Returns scalar (hi, lo)."""
    return _compensated_reduce(x, square=True)


def sum_abs_ds(x):
    """Compensated sum of |x| of all elements. Returns scalar (hi, lo)."""
    return _compensated_reduce(jnp.abs(x), square=False)


def sum_ds(x):
    """Compensated sum of all elements. Returns scalar (hi, lo)."""
    return _compensated_reduce(x, square=False)


def finalize(hi, lo) -> float:
    """Combine a (hi, lo) pair into a python float (f64) on host."""
    return float(hi) + float(lo)
