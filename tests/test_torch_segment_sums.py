"""The two segment sums' plain versions (``kernels.segment_sum`` and
``kernels.segment_sum_shared``, which take them for CPU tensors) vs the JAX
package's Pallas kernels in interpret mode, at the inputs the CUDA kernels'
bucketing and vector stores are sensitive to: one segment taking 90% of
the rows, M = 1, empty segments at both ends, every row routed out by -1 or
by >= M, samples drawn differently, F = 3 and 66 (no multiple of 4) and N
= 77 and 1000 (a multiple of no chunk). ``chip_smoke.py`` runs the kernels
on the same kinds of input on the card (``segment_id_maps``).

Inputs are seeded numpy draws. The id cases use rows of multiples of 1/64
in [-4, 4], whose f32 sums are exact in any order, so they check the
routing alone; the "normal" case uses N(0, 1) rows, whose sums the two
sides round in other orders. Tolerance rtol / atol 1e-5 throughout.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmr_agent_tpu.ops import pallas_kernels as pk
from cmr_agent_tpu_torch.ops import kernels

TOL = dict(rtol=1e-5, atol=1e-5)
KINDS = ("skew", "one_segment", "empty_ends", "all_minus_one", "all_past_m",
         "per_sample", "normal")
# (N, F, M)
SHAPES = ((77, 3, 19), (77, 66, 19), (1000, 3, 37), (1000, 66, 37))


def _grid_rows(rng, *shape):
    return (rng.integers(-256, 257, size=shape) / 64).astype(np.float32)


def _case(kind, b, n, f, m, seed):
    """``(data [b, n, f], idx [b, n], M)`` of one kind."""
    rng = np.random.default_rng(seed)
    data = _grid_rows(rng, b, n, f)
    idx = rng.integers(0, m, size=(b, n)).astype(np.int32)
    if kind == "skew":
        idx[rng.random((b, n)) < 0.9] = m // 2
    elif kind == "one_segment":
        idx, m = rng.integers(-1, 2, size=(b, n)).astype(np.int32), 1
    elif kind == "empty_ends":
        idx = rng.integers(2, m - 2, size=(b, n)).astype(np.int32)
    elif kind == "all_minus_one":
        idx[:] = -1
    elif kind == "all_past_m":
        idx = (m + rng.integers(0, 5, size=(b, n))).astype(np.int32)
    elif kind == "per_sample":
        idx[1] = rng.integers(m // 2, m, size=n)
        idx[1][rng.random(n) < 0.25] = -1
    elif kind == "normal":
        data = rng.normal(size=(b, n, f)).astype(np.float32)
        idx = rng.integers(-1, m + 3, size=(b, n)).astype(np.int32)
    return data, idx, m


def _check_routing(kind, got, m):
    """The sums that must be exactly zero: routed-out samples or
    hypotheses, and the empty end segments. ``got [..., M, F]``."""
    if kind.startswith("all_"):
        assert not got.any()
    if kind == "empty_ends":
        assert not got[..., [0, 1, m - 2, m - 1], :].any()


@pytest.mark.parametrize("n,f,m", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_segment_sum_plain_matches_pallas_interpret(kind, n, f, m):
    data, idx, m = _case(kind, 2, n, f, m, seed=n + f)
    want = np.asarray(pk.segment_sum_fused(
        jnp.asarray(data), jnp.asarray(idx), m, tile=128, interpret=True))
    got = kernels.segment_sum(torch.from_numpy(data), torch.from_numpy(idx),
                              m)
    assert got.shape == (2, m, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _check_routing(kind, got.numpy(), m)


@pytest.mark.parametrize("n,f,m", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_segment_sum_shared_plain_matches_pallas_interpret_cases(kind, n, f,
                                                                 m):
    """Hypothesis 0 takes the case's ids, 1 uniform ids, 2 every row routed
    out (>= M)."""
    data, idx, m = _case(kind, 2, n, f, m, seed=2 * n + f)
    rng = np.random.default_rng(n)
    idx3 = np.stack([idx, rng.integers(0, m, size=(2, n)),
                     np.full((2, n), m)], 1).astype(np.int32)
    want = np.asarray(pk.segment_sum_fused_shared(
        jnp.asarray(data), jnp.asarray(idx3), m, 128, True))
    got = kernels.segment_sum_shared(torch.from_numpy(data),
                                     torch.from_numpy(idx3), m)
    assert got.shape == (2, 3, m, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _check_routing(kind, got.numpy()[:, 0], m)
    assert not got[:, 2].any()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
