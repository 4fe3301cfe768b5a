"""K8's plain version against the JAX reference, on the CPU.

`rank_accept_plain` (cruise_control_tpu_torch/analyzer/kernels.py) and
the reference's `rank_accept` (cruise_control_tpu/analyzer/kernels.py)
take the same numpy-seeded inputs and must return the same flags
exactly, at C = 1, 16, 17, 256, 257, 2048 and 4096 candidates, B = 200
and 2600 brokers and T = 0, 1, 3 and 6 cumulative terms, in each case
chip_smoke.py's phase 2 holds the kernel to: random inputs, every
candidate invalid, every candidate in one segment, equal gains, gains of
+0.0 and -0.0, destinations whose arrivals are already at their cap, and
a term that fails halfway down each segment.  Then at the widest call a
path makes (C = 4 B = 10,400 at 2,600 brokers).  On a CPU tensor the
dispatch `rank_accept` is the plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import kernels as J
from cruise_control_tpu_torch.analyzer import kernels as K

CASES = ("random", "all invalid", "one segment", "equal gains",
         "signed zeros", "taken at cap", "mid-segment failure")

_j_rank_accept = jax.jit(J.rank_accept, static_argnums=(3,))


def _inputs(c: int, b: int, t: int, case: str, rng):
    """(dest i32[C], gain f32[C], has bool[C], taken i32[B], cap i32[B],
    cum f32[T, B], d_w f32[T, C], hr f32[T, B]) as numpy arrays."""
    f32 = np.float32
    dest = rng.integers(0, min(b, max(1, c // 8) + 1), c).astype(np.int32)
    gain = (np.round(rng.random(c) * 8.0) / 4.0).astype(f32)
    has = rng.random(c) < 0.85
    taken = np.where(rng.random(b) < 0.7, 0,
                     rng.integers(1, 4, b)).astype(np.int32)
    cap = rng.integers(24, 65, b).astype(np.int32)
    d_w = (np.round(rng.random((t, c)) * 64.0) / 16.0).astype(f32)
    cum = (np.round(rng.random((t, b)) * 16.0) / 4.0).astype(f32)
    hr = (cum + rng.random((t, b)).astype(f32) * f32(60.0)).astype(f32)
    if case == "all invalid":
        has = np.zeros(c, bool)
    elif case == "one segment":
        dest = np.full(c, b // 2, np.int32)
        cap = np.full(b, 1 << 30, np.int32)
        hr = (cum + f32(0.4 * c)).astype(f32)
    elif case == "equal gains":
        gain = np.ones(c, f32)
    elif case == "signed zeros":
        gain = np.where(rng.random(c) < 0.5, f32(0.0), f32(-0.0)).astype(f32)
    elif case == "taken at cap":
        taken = np.where(rng.random(b) < 0.5, cap, taken).astype(np.int32)
    elif case == "mid-segment failure":
        d_w = np.ones((t, c), f32)
        cum = np.zeros((t, b), f32)
        hr = np.full((t, b), max(1.0, c / (2.0 * max(1, c // 8 + 1))), f32)
        cap = np.full(b, 1 << 30, np.int32)
    return dest, gain, has, taken, cap, cum, d_w, hr


def _both(c, b, t, case, seed):
    rng = np.random.default_rng(seed)
    dest, gain, has, taken, cap, cum, d_w, hr = _inputs(c, b, t, case, rng)
    want = np.asarray(_j_rank_accept(
        jnp.asarray(dest), jnp.asarray(gain), jnp.asarray(has), b,
        jnp.asarray(taken), jnp.asarray(cap), [jnp.asarray(x) for x in cum],
        [jnp.asarray(x) for x in d_w], [jnp.asarray(x) for x in hr]))
    tt = torch.from_numpy
    got = K.rank_accept_plain(
        tt(dest), tt(gain), tt(has), b, tt(taken), tt(cap),
        [tt(x) for x in cum], [tt(x) for x in d_w], [tt(x) for x in hr])
    return want, got.numpy()


@pytest.mark.parametrize("t", [0, 1, 3, 6])
@pytest.mark.parametrize("b", [200, 2600])
@pytest.mark.parametrize("c", [1, 16, 17, 256, 257, 2048, 4096])
def test_rank_accept_plain_matches_reference(c, b, t):
    accepted = 0
    for i, case in enumerate(CASES):
        want, got = _both(c, b, t, case, seed=1000 * c + 10 * t + i + b)
        assert got.dtype == np.bool_ and got.shape == (c,)
        assert np.array_equal(want, got), (case, int((want != got).sum()))
        if case == "all invalid":
            assert not got.any()
        accepted += int(got.sum())
    assert accepted > 0


def test_rank_accept_plain_matches_reference_at_the_widest_call():
    """C = 4 B at 2,600 brokers: the forced-move round's table branch and
    the capacity goals' full-width fallback."""
    for i, case in enumerate(CASES):
        want, got = _both(10_400, 2600, 3, case, seed=77 + i)
        assert np.array_equal(want, got), case


def test_rank_accept_mid_segment_failure_cuts_the_prefix():
    """A failing rank blocks every later rank of its segment: in one
    segment of unit weights under a headroom of 5, exactly the five best
    ranks land."""
    c, b = 12, 4
    dest = torch.full((c,), 2, dtype=torch.int32)
    gain = torch.arange(c, dtype=torch.float32)
    has = torch.ones(c, dtype=torch.bool)
    zeros_b = torch.zeros(b)
    got = K.rank_accept(dest, gain, has, b, torch.zeros(b, dtype=torch.int32),
                        torch.full((b,), 64, dtype=torch.int32), [zeros_b],
                        [torch.ones(c)], [torch.full((b,), 5.0)])
    assert got.tolist() == [False] * 7 + [True] * 5


def test_rank_accept_dispatch_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(5)
    dest, gain, has, taken, cap, cum, d_w, hr = _inputs(300, 200, 3,
                                                        "random", rng)
    tt = torch.from_numpy
    args = (tt(dest), tt(gain), tt(has), 200, tt(taken), tt(cap),
            list(tt(cum)), list(tt(d_w)), list(tt(hr)))
    assert torch.equal(K.rank_accept(*args), K.rank_accept_plain(*args))
