"""The port's CUDA kernels against their plain PyTorch versions on the
card, at the slice's shapes (marker `torch_cuda`).

Each test decides inside itself whether a card is present and skips
with a reason when none is; run them on a machine with the card with
``JAX_PLATFORMS=cpu python -m pytest --noconftest -m torch_cuda
tests/test_torch_cuda.py`` (the suite's conftest needs JAX, which such a
machine may lack; JAX, where present, stays on the CPU).  Integers
and booleans must match exactly, and so must K3's float aggregates (the
kernel adds in the plain version's order).
"""
import numpy as np
import pytest
import torch

try:
    import jax
except ImportError:  # the card's machine carries no JAX
    jax = None

from cruise_control_tpu_torch.analyzer import context as C
from cruise_control_tpu_torch.analyzer import kernels as K
from cruise_control_tpu_torch.testing.random_cluster import (
    RandomClusterSpec, random_cluster)

pytestmark = pytest.mark.torch_cuda

SLICE = dict(num_brokers=200, num_partitions=20_000, replication_factor=3,
             num_racks=8, num_topics=10, seed=4, skew_fraction=0.2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m torch_cuda)")
    from cruise_control_tpu_torch import cuda_kernels
    cuda_kernels.build()
    return cuda_kernels


def _same(a, b):
    return a.dtype == b.dtype and bool(torch.equal(a, b))


@pytest.mark.parametrize("k", [1, 4, 8])
def test_row_topk_matches_plain(k):
    ck = _card()
    rng = np.random.default_rng(k)
    sc = np.round(rng.random((200, 1152)) * 40).astype(np.float32)
    sc[rng.random(sc.shape) < 0.3] = K.NEG
    sc[3] = K.NEG
    sc[4] = 1.0
    sc_t = torch.from_numpy(sc).cuda()
    table = torch.from_numpy(rng.permutation(200 * 1152).astype(
        np.int32).reshape(200, 1152)).cuda()
    got = ck.row_topk(sc_t, table, k)
    want = K.row_topk_plain(sc_t, table, k)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("kk,k", [(256, 0), (256, 3), (200, 0), (200, 5)])
def test_assign_pass_matches_plain(kk, k):
    ck = _card()
    rng = np.random.default_rng(kk + k)
    c = 2048
    pref = -rng.random((c, kk)).astype(np.float32)
    pref[rng.random(pref.shape) < 0.3] = K.NEG
    pref[:, 7] = pref[:, 2]
    args = [torch.from_numpy(x).cuda() for x in (
        pref, rng.random(kk) < 0.8, rng.random(c) < 0.2, rng.random(c) < 0.9)]
    amp = torch.tensor(0.35 * 1.0 + 1e-6, dtype=torch.float32).cuda()
    got = ck.assign_pass(*args, k, amp)
    want = K.assign_pass_plain(*args, k, amp)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want))


def test_commit_moves_matches_plain_bit_for_bit():
    ck = _card()
    state, _ = random_cluster(RandomClusterSpec(**SLICE), device="cuda")
    ctx = C.make_context(state, C.BalancingConstraint(),
                         C.OptimizationOptions())
    cache = C.make_round_cache(state, ctx.table_slots, ctx)
    rng = np.random.default_rng(0)
    n = 2048
    r = torch.from_numpy(rng.choice(state.num_replicas, size=n,
                                    replace=False).astype(np.int32)).cuda()
    dst = torch.from_numpy((rng.integers(0, 64, size=n) * 3 % 200).astype(
        np.int32)).cuda()
    valid = (torch.from_numpy(rng.random(n) < 0.9).cuda()
             & (state.replica_broker[r.long()] != dst))
    rank = C.arrival_rank(dst, valid, state.num_brokers)
    got = ck.commit_moves(state, cache, r, dst, valid, rank)
    want = C.commit_moves_plain(state, cache, r, dst, valid, rank)
    torch.cuda.synchronize()
    for f in want:
        assert _same(got[f], want[f]), f


def test_reference_stays_on_the_cpu():
    """The port's tests run JAX on the CPU beside the card's torch."""
    if jax is None:
        pytest.skip("JAX is not installed here")
    assert jax.default_backend() == "cpu"
