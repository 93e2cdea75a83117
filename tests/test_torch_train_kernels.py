"""The training path's kernel plain versions and autograd Functions vs the
JAX package's Pallas kernels and their VJPs.

JAX reference in every test: the Pallas kernel in ``interpret=True`` mode
on the CPU (``jax.vjp`` of it for the backward passes, whose interpret
branches gather with ``take_along_axis``). The port's wrappers take their
plain versions because the tensors lie on the CPU. Inputs come from numpy
seeds; tolerance atol 1e-5 in f32 (sums in another order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmr_agent_tpu.ops import pallas_kernels as pk
from cmr_agent_tpu_torch.ops import kernels

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _segment_inputs(seed, b=2, n=600, m=37, f=16):
    """Rows with ids in [0, m-5) (5 empty segments, segment 0 real), some
    routed out with ids >= m (the JAX convention) and some with -1."""
    rng = np.random.default_rng(seed)
    attn = (rng.normal(size=(b, n, f)) * 3).astype(np.float32)
    values = rng.normal(size=(b, n, f)).astype(np.float32)
    idx = rng.integers(0, m - 5, size=(b, n)).astype(np.int32)
    idx[:, :20] = m + 3
    idx[:, 20:30] = -1
    idx[:, 30:40] = 0
    return attn, values, idx, m


def test_segment_sum_plain_matches_jax():
    data, _, idx, m = _segment_inputs(0)
    want = np.asarray(pk.segment_sum_fused(
        jnp.asarray(data), jnp.asarray(idx), m, tile=128, interpret=True))
    got = kernels.segment_sum(_t(data), _t(idx), m).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all(got[:, m - 5:] == 0.0)


def test_segment_softmax_backward_matches_jax_vjp_and_autograd():
    """dattn/dvalues from the closed form (kernel residuals) vs jax.vjp of
    segment_softmax_attend_fused, and vs torch.autograd through the plain
    forward; routed-out rows get exactly zero. (The JAX VJP's interpret
    branch gathers with take_along_axis, which fills NaN for out-of-range
    ids, so only in-range rows are compared with it; its compiled branch
    gathers zero rows and gives 0, as the port does.)"""
    attn, values, idx, m = _segment_inputs(1)
    g = np.random.default_rng(2).normal(size=(2, m, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, v: pk.segment_softmax_attend_fused(
        a, v, jnp.asarray(idx), m, 128, True), jnp.asarray(attn),
        jnp.asarray(values))
    want_da, want_dv = (np.asarray(x) for x in vjp(jnp.asarray(g)))

    a = _t(attn).requires_grad_()
    v = _t(values).requires_grad_()
    out = kernels.SegmentSoftmaxAttendFn.apply(a, v, _t(idx), m)
    out.backward(_t(g))
    routed_out = (idx < 0) | (idx >= m)
    np.testing.assert_allclose(a.grad.numpy()[~routed_out],
                               want_da[~routed_out], atol=ATOL)
    np.testing.assert_allclose(v.grad.numpy()[~routed_out],
                               want_dv[~routed_out], atol=ATOL)
    assert np.all(a.grad.numpy()[routed_out] == 0.0)
    assert np.all(v.grad.numpy()[routed_out] == 0.0)

    a2 = _t(attn).requires_grad_()
    v2 = _t(values).requires_grad_()
    kernels.segment_softmax_attend_plain(a2, v2, _t(idx), m).backward(_t(g))
    np.testing.assert_allclose(a.grad.numpy(), a2.grad.numpy(), atol=ATOL)
    np.testing.assert_allclose(v.grad.numpy(), v2.grad.numpy(), atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_backward_matches_jax_vjp(dtype):
    """The gather's VJP is the segment sum of the gradient widened to f32,
    cast back to the table's dtype; out-of-range rows add nothing."""
    rng = np.random.default_rng(3)
    b, m, n, f = 2, 50, 400, 8
    table = rng.normal(size=(b, m, f)).astype(np.float32)
    idx = rng.integers(-3, m + 3, size=(b, n)).astype(np.int32)
    g = rng.normal(size=(b, n, f)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(lambda t: pk.gather_rows_fused(t, jnp.asarray(idx), 128,
                                                    True),
                     jnp.asarray(table, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))
    want = np.asarray(want.astype(jnp.float32))

    tdt = getattr(torch, dtype)
    t = _t(table).to(tdt).requires_grad_()
    out = kernels.GatherRowsFn.apply(t, _t(idx))
    out.backward(_t(g).to(tdt))
    assert t.grad.dtype == tdt
    # bf16: both sum bf16-rounded gradients in f32, then round once
    tol = ATOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(t.grad.float().numpy(), want, atol=tol)


def _image_inputs(seed):
    """Valid-first rows (a top-K compacted layout): the first rows land in
    the image, then a dead tail routed out with id h*w."""
    rng = np.random.default_rng(seed)
    b, k, f, h, w = 2, 700, 8, 6, 10
    data = rng.normal(size=(b, k, f)).astype(np.float32)
    ids = rng.integers(0, h * w, size=(b, k)).astype(np.int32)
    ids[0, 450:] = h * w
    ids[1, 200:] = h * w
    return data, ids, h, w


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_segment_mean_count_image_plain_and_vjp_match_jax(mode):
    """Means and counts (counts exact) of the flat image raster, and its
    VJP, vs segment_mean_count_image_fused(factored=False). bf16: both
    round the same rows to bf16 once and sum in f32."""
    data, ids, h, w = _image_inputs(4)
    jdt = None if mode == "float32" else jnp.bfloat16
    tdt = None if mode == "float32" else torch.bfloat16
    g = np.random.default_rng(5).normal(size=(2, h * w, 8)).astype(np.float32)

    def fwd(d):
        return pk.segment_mean_count_image_fused(
            d, jnp.asarray(ids), h, w, tile=128, factored=False,
            compute_dtype=jdt, interpret=True)

    (want_m, want_c), vjp = jax.vjp(fwd, jnp.asarray(data))
    (want_d,) = vjp((jnp.asarray(g), jnp.zeros_like(want_c)))

    d = _t(data).requires_grad_()
    got_m, got_c = kernels.SegmentMeanCountImageFn.apply(d, _t(ids), h, w,
                                                         tdt)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_c.numpy().sum() == 450 + 200
    np.testing.assert_allclose(got_m.detach().numpy(), np.asarray(want_m),
                               atol=ATOL)
    got_m.backward(_t(g))
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want_d), atol=ATOL)
    assert np.all(d.grad.numpy()[0, 450:] == 0.0)


def test_image_raster_refuses_int8():
    """The pixel-id raster serves int8 operands (the bf16 eval episodes'
    "flat" and "topk" rasters): on a valid-first layout its counts equal
    the Pallas kernel's in int8 and its means agree within 1e-5 (one absmax
    quantisation, exact integer sums in both). A compute dtype it has no
    mode for is refused."""
    data, ids, h, w = _image_inputs(6)
    got_m, got_c = kernels.segment_mean_count_image(_t(data), _t(ids), h, w,
                                                    torch.int8)
    want_m, want_c = pk.segment_mean_count_image_fused(
        jnp.asarray(data), jnp.asarray(ids), h, w, tile=128, factored=False,
        compute_dtype=jnp.int8, interpret=True)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="float16"):
        kernels.segment_mean_count_image(_t(data), _t(ids), h, w,
                                         torch.float16)
