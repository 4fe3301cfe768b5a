"""Tensor primitives the port needs in JAX's exact semantics.

* Segment reductions drop out-of-range segment ids (JAX's default
  ``mode="drop"``): ids outside [0, n) go to a spill row that is sliced
  off.
* Float segment sums and scatter-adds add in update order, as XLA's
  scatter does, so that the port's sums equal the reference's bit for bit
  (`segment_sum`, `scatter_add_seq`).
* Float sums and cumulative sums follow XLA:CPU's order (`sum_f32`,
  `cumsum_f32_plain`).
* top-k and argsort keep JAX's tie rule: equal keys in index order.

The exact-order float primitives run a hand-written kernel on the card
(K12 `segment_sum`, K13 `ordered_sum`, csrc/) and their plain versions
(`segment_sum_plain`, `scatter_add_seq_plain`, `sum_f32_plain`) on the
CPU.  The row scan `cumsum_f32_plain` is the plain scan of K14's prefix
gate (analyzer/kernels.py `prefix_gate`) and of K8's plain version.
Integer segment sums stay `index_add_` everywhere: integer adds are exact
in any order.
"""
from __future__ import annotations

import torch

INT32_MAX = 2 ** 31 - 1


def _spill_ids(seg: torch.Tensor, n: int) -> torch.Tensor:
    seg = seg.long()
    return torch.where((seg >= 0) & (seg < n), seg, torch.full_like(seg, n))


def _index_add(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """`x` summed into n rows by `index_add_` (ids equal to n dropped)."""
    out = torch.zeros((n + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out.index_add_(0, ids, x)
    return out[:n]


def segment_sum_plain(x: torch.Tensor, seg: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Plain version of K12, `jax.ops.segment_sum(x, seg, num_segments=n)`:
    out-of-range ids are dropped, and every float sum adds in index order,
    as XLA's scatter does.  The CPU's `index_add_` is sequential; on the
    card (whose `index_add_` adds with atomics, in no fixed order) float
    values are laid out as a [segment, rank] matrix and summed column by
    column, which is the same sequential order."""
    ids = _spill_ids(seg, n)
    if not (x.is_cuda and x.dtype.is_floating_point):
        return _index_add(x, ids, n)
    mat, _, width = _rank_matrix(x, ids, n)
    acc = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    for j in range(width):
        acc = acc + mat[:n, j]
    return acc


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.ops.segment_sum(x, seg, num_segments=n)` (see
    `segment_sum_plain`): K12 for a float tensor on the card, `index_add_`
    for an integer one, the plain version on the CPU."""
    if not x.is_cuda:
        return segment_sum_plain(x, seg, n)
    if not x.dtype.is_floating_point:
        return _index_add(x, _spill_ids(seg, n), n)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.segment_sum(x.contiguous(), _ids(seg), n)


def _ids(seg: torch.Tensor) -> torch.Tensor:
    """Segment ids as K12 takes them: int32 or int64, contiguous."""
    if seg.dtype not in (torch.int32, torch.int64):
        seg = seg.long()
    return seg.contiguous()


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


def scatter_add_seq_plain(arr: torch.Tensor, idx: torch.Tensor,
                          vals: torch.Tensor) -> torch.Tensor:
    """Plain version of K12 with `init`: `arr.at[idx].add(vals,
    mode="drop")` adding in UPDATE ORDER on any device (ids outside
    [0, n) are dropped; the callers spill to n, and never pass the
    negative ids that JAX's `.at` would wrap).  The CPU's
    `index_add_` is already sequential; on the card the updates are laid
    out as a [target, rank] matrix and added column by column (column t
    holds each target's t-th update), so every sum is the sequential
    one."""
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


def scatter_add_seq(arr: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """`arr.at[idx].add(vals, mode="drop")` adding in update order (see
    `scatter_add_seq_plain`): K12 from `arr` on the card (float32 only),
    the plain version on the CPU."""
    if not arr.is_cuda:
        return scatter_add_seq_plain(arr, idx, vals)
    from cruise_control_tpu_torch import cuda_kernels
    return cuda_kernels.segment_sum(vals.contiguous(), _ids(idx),
                                    arr.shape[0], init=arr.contiguous())


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


def cumsum_f32_plain(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Plain version of K14: inclusive float cumsum in XLA:CPU's order,
    sequential within blocks of 16, block totals scanned recursively, each
    block's carry added to its sums.  Rows of 16 or fewer are plainly
    sequential from +0.0 (so a leading -0.0 becomes +0.0), except a row of
    one, which XLA copies."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= 16:
        if n <= 1:
            return x.clone().movedim(-1, dim)
        cols = [torch.zeros_like(x[..., 0]) + x[..., 0]]
        for j in range(1, n):
            cols.append(cols[-1] + x[..., j])
        return torch.stack(cols, -1).movedim(-1, dim)
    m = -(-n // 16)
    pad = torch.zeros(x.shape[:-1] + (m * 16 - n,), dtype=x.dtype,
                      device=x.device)
    blocks = torch.cat([x, pad], -1).reshape(x.shape[:-1] + (m, 16))
    inb = cumsum_f32_plain(blocks)
    carry_incl = cumsum_f32_plain(inb[..., -1])
    carry = torch.cat([torch.zeros_like(carry_incl[..., :1]),
                       carry_incl[..., :-1]], -1)
    out = (inb + carry[..., None]).reshape(x.shape[:-1] + (m * 16,))
    return out[..., :n].movedim(-1, dim)


def topk_stable(x: torch.Tensor, k: int):
    """`jax.lax.top_k` along the last axis: (values, indices int64), ties
    in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_total(x: torch.Tensor, k: int):
    """`jax.lax.top_k` of float32 values along the last axis, in XLA's
    float total order (-0.0 below +0.0; `topk_stable` ties them): (values,
    indices int64), ties in index order."""
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx


def remainder_f(x: torch.Tensor, y: float) -> torch.Tensor:
    """`jnp.remainder` for floats: the truncated remainder shifted into
    the divisor's sign (exact; torch.remainder rounds differently)."""
    rem = torch.fmod(x, y)
    return torch.where((rem != 0) & ((rem < 0) != (y < 0)), rem + y, rem)


def argsort_stable(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """`jnp.argsort(x, stable=True)` (int64 indices)."""
    return torch.sort(x, dim=dim, stable=True).indices


def sum_f32_plain(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Plain version of K13: float sum along `dim` in XLA:CPU's order:
    while more than 32 terms remain, they are zero-padded to a multiple of
    32 (the padding split evenly before and after) and each window of 32
    is summed sequentially; the last <= 32 terms are summed sequentially
    from +0.0.  A sum of one term is that term (XLA copies it, so a -0.0
    stays -0.0)."""
    x = x.movedim(dim, 0)
    rest = tuple(x.shape[1:])
    n = x.shape[0]
    if n == 1:
        return x[0].clone()
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


def sum_f32(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Float sum along `dim` in XLA:CPU's order (see `sum_f32_plain`): K13
    on the card, the plain version on the CPU."""
    if not x.is_cuda:
        return sum_f32_plain(x, dim)
    from cruise_control_tpu_torch import cuda_kernels
    xm = x.movedim(dim, 0)
    rest = tuple(xm.shape[1:])
    cols = xm.reshape(xm.shape[0], torch.Size(rest).numel()).contiguous()
    return cuda_kernels.ordered_sum(cols).reshape(rest)


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
