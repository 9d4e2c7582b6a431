"""The yardstick of the roofline shares: the card's peaks and the least
work a stage needs, counted from the shapes a cell runs.

The integer rate is the data sheet's fp32 non-tensor rate of one H100 SXM
(67 TFLOP/s = 132 SMs x 128 lanes x 2 x 1.98 GHz) scaled to Hopper's 64
INT32 lanes per SM, one operation per lane and clock; the HBM3 rate is the
data sheet's.  Both assume the card's full 700 W.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# 32-bit operations per work item, counted from the hash family: mix32 =
# 3 shifts + 3 xors + 2 multiplies = 8; hash_u32 = 2 mix32 + add + xor +
# multiply = 19; row_salt = 3; a bucket = hash + mask (a power-of-two width)
# = 20; a sign = salt xor + hash + and + select = 22; an address = 2.
# -logf and the power count one operation each, so these are lower bounds.
OPS_PER_ROW = 3 + 20 + 22 + 2
TRANSFORM_OPS = 24 + 2 + 3  # uniform01, log and power, mask

# A median-of-7 selection network: 13 comparators, the median on wire 3
# (N. Devillard, "Fast median search: an ANSI C implementation", 1998).
MEDIAN7_NETWORK = ((0, 5), (0, 3), (1, 6), (2, 4), (0, 1), (3, 5), (2, 6),
                   (2, 3), (3, 6), (4, 5), (1, 4), (1, 3), (3, 4))


def slot_ops(rows: int) -> int:
    """Operations a live slot of a scatter or a dense update needs: each
    row's hashing, the transform once."""
    return rows * OPS_PER_ROW + TRANSFORM_OPS


def query_ops(rows: int) -> int:
    """Operations a key's row reads need (a sign multiply a row)."""
    return rows * (OPS_PER_ROW + 1)


def select_ops(rows: int) -> int:
    """The least work the median of 7 reads needs: the comparators of
    ``MEDIAN7_NETWORK`` that reach the median, a NaN test a row, the add
    and the multiply."""
    if rows != 7:
        raise ValueError(f"no median network is counted for {rows} rows")
    need, ops = {3}, 0
    for i, j in reversed(MEDIAN7_NETWORK):
        ops += (i in need) + (j in need)
        if i in need or j in need:
            need |= {i, j}
    return ops + rows + 2


OPS = {"slot_ops": slot_ops, "query_ops": query_ops,
       "select_ops": select_ops}


def least_seconds(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time for ``nbytes`` moved and ``ops`` 32-bit operations,
    and which of the two bounds it."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")
