"""The blind rotation's least time on one H100: the yardstick of the
`rotation_roofline_pct.*` metrics.

The count is fixed by the parameter set and the rows rotated, whatever
implements the product:

- operations: 2 x the int8 multiply-adds that a row's step needs, with one
  int8 per gadget digit: (k+1) l digit polynomials x (k+1) output
  polynomials x N^2 coefficient products x 4 key limbs (a uint32 key word
  is four int8 limbs) x 9/16. The 9/16 is two levels of Karatsuba, the
  fewest multiply-adds of any product the program has or plans, so no
  implementation of it reads above 100 %;
- bytes: each rotation call reads its accumulator and writes it once
  ([rows, k+1, N] uint32) and reads its rotations once ([n0, rows] int32);
  the bootstrapping key ([n0, (k+1) l, k+1, N] uint32) is read once per
  traced window, as a key that stays on the chip between calls would be
  (31.3 MB at tfhepp_128bit fits the 50 MB L2);
- the least time is the larger of operations over the int8 peak and bytes
  over the memory peak.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense: int8 tensor-core operations a second
#: (a multiply-add is two) and HBM3 bytes a second, at the 700 W limit
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
#: two levels of Karatsuba: 9 of 16 schoolbook products
KARATSUBA2 = 9 / 16


def rotation_ops(p, rows: int) -> float:
    """int8 operations of `rows` blind rotations at parameters p (the
    reference's Params: n0, N, k, l)."""
    kp1 = p.k + 1
    per_step = 2 * kp1 * p.l * kp1 * p.N * p.N * 4 * KARATSUBA2
    return per_step * p.n0 * rows


def rotation_bytes(p, rows: int) -> float:
    """Bytes of rotation calls over `rows` rows in all, and the key once."""
    acc = 2 * rows * (p.k + 1) * p.N * 4
    abar = rows * p.n0 * 4
    key = p.n0 * (p.k + 1) * p.l * (p.k + 1) * p.N * 4 if rows else 0
    return acc + abar + key


def rotation_least_s(p, rows: int) -> tuple:
    """(least seconds, "operations" or "bytes": what bounds it)."""
    t_ops = rotation_ops(p, rows) / INT8_OPS_PER_S
    t_bytes = rotation_bytes(p, rows) / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
