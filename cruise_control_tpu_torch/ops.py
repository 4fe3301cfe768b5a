"""Tensor primitives the port needs in JAX's exact semantics.

* Segment reductions drop out-of-range segment ids (JAX's default
  ``mode="drop"``): ids outside [0, n) go to a spill row that is sliced
  off.
* Float scatter-adds must add in update order, as XLA's scatter does, so
  that the port's sums equal the reference's bit for bit
  (`scatter_add_seq`).
* Float cumulative sums follow XLA:CPU's order (`cumsum_f32`).
* top-k and argsort keep JAX's tie rule: equal keys in index order.
"""
from __future__ import annotations

import torch

INT32_MAX = 2 ** 31 - 1


def _spill_ids(seg: torch.Tensor, n: int) -> torch.Tensor:
    seg = seg.long()
    return torch.where((seg >= 0) & (seg < n), seg, torch.full_like(seg, n))


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.ops.segment_sum(x, seg, num_segments=n)`: out-of-range ids
    are dropped, and every float sum adds in index order, as XLA's
    scatter does.  The CPU's `index_add_` is sequential; on the card
    (whose `index_add_` adds with atomics, in no fixed order) float
    values are laid out as a [segment, rank] matrix and summed column by
    column, which is the same sequential order."""
    ids = _spill_ids(seg, n)
    if not (x.is_cuda and x.dtype.is_floating_point):
        out = torch.zeros((n + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        out.index_add_(0, ids, x)
        return out[:n]
    mat, _, width = _rank_matrix(x, ids, n)
    acc = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    for j in range(width):
        acc = acc + mat[:n, j]
    return acc


def segment_max(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.ops.segment_max`; empty segments hold the dtype's lowest
    value (-inf for floats)."""
    low = (-float("inf") if x.dtype.is_floating_point
           else torch.iinfo(x.dtype).min)
    out = torch.full((n + 1,), low, dtype=x.dtype, device=x.device)
    out.scatter_reduce_(0, _spill_ids(seg, n), x, "amax", include_self=True)
    return out[:n]


def segment_min(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.ops.segment_min`; empty segments hold the dtype's highest
    value."""
    high = (float("inf") if x.dtype.is_floating_point
            else torch.iinfo(x.dtype).max)
    out = torch.full((n + 1,), high, dtype=x.dtype, device=x.device)
    out.scatter_reduce_(0, _spill_ids(seg, n), x, "amin", include_self=True)
    return out[:n]


def scatter_set(arr: torch.Tensor, idx: torch.Tensor,
                vals) -> torch.Tensor:
    """`arr.at[idx].set(vals, mode="drop")` on the leading axis; the valid
    ids must be unique (duplicates only at dropped rows)."""
    n = arr.shape[0]
    out = torch.cat([arr, arr[:1]])
    out[_spill_ids(idx, n)] = vals
    return out[:n]


def scatter_add_seq(arr: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """`arr.at[idx].add(vals, mode="drop")` adding in UPDATE ORDER on any
    device.  The CPU's `index_add_` is already sequential; on the card
    the updates are laid out as a [target, rank] matrix and added column
    by column (column t holds each target's t-th update), so every sum is
    the sequential one."""
    n = arr.shape[0]
    ids = _spill_ids(idx, n)
    if not arr.is_cuda:
        out = torch.cat([arr, torch.zeros_like(arr[:1])])
        out.index_add_(0, ids, vals)
        return out[:n]
    mat, counts, width = _rank_matrix(vals, ids, n)
    acc = arr
    for j in range(width):
        has = (counts[:n] > j).reshape((n,) + (1,) * (arr.dim() - 1))
        acc = torch.where(has, acc + mat[:n, j], acc)
    return acc


def _rank_matrix(x: torch.Tensor, ids: torch.Tensor, n: int):
    """([n + 1, width, ...] matrix whose row t lists x's entries with id
    t in index order, zero-padded; per-id counts; width = the largest
    count below n).  Ids equal to n (dropped) all land in row n, column
    0.  One host sync, for the width."""
    order = torch.sort(ids, stable=True).indices
    ids_s = ids[order]
    counts = torch.bincount(ids_s, minlength=n + 1)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(ids.shape[0], device=x.device) - start[ids_s]
    rank = torch.where(ids_s < n, rank, torch.zeros_like(rank))
    width = int(counts[:n].max()) if n else 0
    mat = torch.zeros((n + 1, max(width, 1)) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    mat[ids_s, rank] = x[order]
    return mat, counts, width


def cumsum_f32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive float cumsum in XLA:CPU's order: sequential within
    blocks of 16, block totals scanned recursively, each block's carry
    added to its sums.  Rows of 16 or fewer are plainly sequential."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= 16:
        cols = [x[..., 0]] if n else []
        for j in range(1, n):
            cols.append(cols[-1] + x[..., j])
        out = torch.stack(cols, -1) if n else x
        return out.movedim(-1, dim)
    m = -(-n // 16)
    pad = torch.zeros(x.shape[:-1] + (m * 16 - n,), dtype=x.dtype,
                      device=x.device)
    blocks = torch.cat([x, pad], -1).reshape(x.shape[:-1] + (m, 16))
    inb = cumsum_f32(blocks)
    carry_incl = cumsum_f32(inb[..., -1])
    carry = torch.cat([torch.zeros_like(carry_incl[..., :1]),
                       carry_incl[..., :-1]], -1)
    out = (inb + carry[..., None]).reshape(x.shape[:-1] + (m * 16,))
    return out[..., :n].movedim(-1, dim)


def topk_stable(x: torch.Tensor, k: int):
    """`jax.lax.top_k` along the last axis: (values, indices int64), ties
    in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def remainder_f(x: torch.Tensor, y: float) -> torch.Tensor:
    """`jnp.remainder` for floats: the truncated remainder shifted into
    the divisor's sign (exact; torch.remainder rounds differently)."""
    rem = torch.fmod(x, y)
    return torch.where((rem != 0) & ((rem < 0) != (y < 0)), rem + y, rem)


def argsort_stable(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """`jnp.argsort(x, stable=True)` (int64 indices)."""
    return torch.sort(x, dim=dim, stable=True).indices


def sum_f32(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Float sum along `dim` in XLA:CPU's order: while more than 32
    terms remain, they are zero-padded to a multiple of 32 (the padding
    split evenly before and after) and each window of 32 is summed
    sequentially; the last <= 32 terms are summed sequentially.  Plain
    elementwise adds, so the card gives the same bits."""
    x = x.movedim(dim, 0)
    rest = tuple(x.shape[1:])
    n = x.shape[0]
    while n > 32:
        m = -(-n // 32)
        lo = (m * 32 - n) // 2
        z = torch.zeros((m * 32,) + rest, dtype=x.dtype, device=x.device)
        z[lo:lo + n] = x
        blocks = z.reshape((m, 32) + rest)
        acc = torch.zeros((m,) + rest, dtype=x.dtype, device=x.device)
        for j in range(32):
            acc = acc + blocks[:, j]
        x, n = acc, m
    acc = torch.zeros(rest, dtype=x.dtype, device=x.device)
    for j in range(n):
        acc = acc + x[j]
    return acc


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add ``a * b + c`` rounded once, as XLA:CPU
    computes a product and a sum that it fuses into one FMA.  The product
    of two float32 values is exact in float64; the float64 sum's rounding
    error is recovered exactly (TwoSum), and a float64 sum that lands on a
    float32 midpoint is moved to the side the error points to, so the
    result is the correctly rounded one, not a double rounding."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    r = s.float()
    d = s - r.double()
    # s halfway between r and its neighbour toward d: the exact value
    # lies beyond the midpoint when err points the same way as d
    toward = torch.where(d > 0, torch.full_like(r, float("inf")),
                         torch.full_like(r, -float("inf")))
    nb = torch.nextafter(r, toward)
    half = (nb.double() - r.double()) / 2.0
    fix = (d != 0) & (d == half) & (err != 0) & ((err > 0) == (d > 0))
    return torch.where(fix, nb, r)
