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
from cmr_agent_tpu.ops import scatter
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


# One bf16 rounding at a tensor's max: the port's bf16 gradients are the
# f32 closed form rounded once, so each lies within half of this of the
# exact gradient.
BF16_ULP = 2.0 ** -8

# The bf16 train steps' gate (tests/test_torch_train_{geo,agent,iter}.py):
# per tensor, the port's distance from the JAX package's bf16 step at most
# BF16_MULTIPLE times JAX-bf16's own distance from an f64 reference of the
# same step, plus one bf16 rounding of the reference's max. Both packages
# round the same values to bf16 at the same places, so their distances
# from the reference are draws of one noise: on the CPU host (the tests'
# junit properties: micro geo step, 427 gradients; BC + PPO update, 90;
# tiny IterModel step, 28) the largest ratio of the two was 3.20, 1.79 and
# 2.01, the 3.20 the only tensor past 2 (the pc overlap head's last bias,
# whose gradient is a sum over the points that cancels to a few percent of
# its terms). So at most BF16_SHARE_PAST of the tensors may pass the
# multiple, none BF16_CAP times JAX's distance: a wrong term moves a
# tensor by far more than its bf16 noise (and a step left in f32 fails the
# check that the port's own noise is of JAX's size).
BF16_MULTIPLE, BF16_SHARE_PAST, BF16_CAP = 2.0, 0.1, 8.0


def assert_within_jax_bf16_noise(tensors, gradients: bool = True):
    """``tensors``: name -> (port, JAX bf16, f64 reference) arrays of one
    tensor (a gradient, a running statistic). Asserts the gate above and,
    for ``gradients``, that the port's step really ran in bf16: over the
    tensors where JAX's bf16 noise clears the floor, the median of the
    port's distance from the reference over JAX's is at least 1/4 (an f32
    step sits ~1e-4). A running statistic moves by a tenth of a batch
    statistic taken in f32, so its bf16 noise stays under the floor.
    Returns the gate's figures (the largest ratio of the two distances,
    the count past the multiple), which the tests record as junit
    properties."""
    past, own, ratios = [], [], []
    for name, (got, jx, ref) in tensors.items():
        got, jx, ref = (np.asarray(a, np.float64) for a in (got, jx, ref))
        assert got.shape == ref.shape, name
        floor = BF16_ULP * np.abs(ref).max()
        d_pj, d_jr = np.abs(got - jx).max(), np.abs(jx - ref).max()
        assert d_pj <= BF16_CAP * d_jr + floor, (name, d_pj, d_jr)
        ratios.append(d_pj / max(d_jr, floor, 1e-30))
        if d_pj > BF16_MULTIPLE * d_jr + floor:
            past.append(name)
        if d_jr > floor:
            own.append(np.abs(got - ref).max() / d_jr)
    assert len(past) <= BF16_SHARE_PAST * len(tensors), past
    if gradients:
        assert own and np.median(own) >= 0.25, own
    return {"tensors": len(tensors), "past_multiple": len(past),
            "max_ratio": float(max(ratios)), "median_port_vs_jax_noise":
            float(np.median(own)) if own else None}


def assert_scalar_within_jax_bf16_noise(got, jx, ref, floor):
    """One loss term or metric: ``|port - JAX bf16| <= BF16_MULTIPLE
    |JAX bf16 - f64| + floor``."""
    assert abs(got - jx) <= BF16_MULTIPLE * abs(jx - ref) + floor, \
        (got, jx, ref)


@pytest.mark.parametrize("seed", [11, 12])
def test_segment_softmax_backward_bf16_matches_jax_vjp(seed,
                                                     record_property):
    """bf16 leaves through ``SegmentSoftmaxAttendFn`` against ``jax.vjp``
    of ``segment_softmax_attend_fused(interpret=True)`` on the same leaves,
    both against an f64 reference (``jax.vjp`` of the JAX package's XLA
    segment softmax on the leaves widened to f64).

    The port widens the operands and rounds each gradient once to bf16, so
    it lies within half a bf16 rounding of the reference (asserted at one;
    0.20-0.38% of the max here). JAX's ``_bwd`` subtracts the max and
    exponentiates in bf16 and hands back f32 cotangents: 0.47-1.02% of the
    max off the reference, ``out`` 0.81-1.02% (its forward exponentiates
    in bf16 too; the port's is within 4e-8). The tolerance follows: per
    tensor, the port's distance from JAX at most JAX's own distance from
    the reference plus one bf16 rounding of the max (the triangle
    inequality, so no share may fall past it); the ratio of the two
    distances was 0.89-1.24. Each test records its distances as junit
    properties."""
    attn, values, idx, m = _segment_inputs(seed, n=1024, m=64)
    g = np.random.default_rng(seed + 1).normal(size=(2, m, 16)).astype(
        np.float32)
    ab = jnp.asarray(attn, jnp.bfloat16)
    vb = jnp.asarray(values, jnp.bfloat16)
    out_j, vjp = jax.vjp(lambda a, v: pk.segment_softmax_attend_fused(
        a, v, jnp.asarray(idx), m, 128, True), ab, vb)
    da_j, dv_j = vjp(jnp.asarray(g))
    # JAX hands f32 cotangents upstream of bf16 leaves
    assert da_j.dtype == dv_j.dtype == jnp.float32
    leaves = [np.asarray(x.astype(jnp.float32), np.float64) for x in (ab, vb)]
    with jax.enable_x64(True):
        out64, vjp64 = jax.vjp(
            lambda a, v: scatter.batched_segment_softmax_attend(
                a, v, jnp.asarray(idx), m),
            *(jnp.asarray(x) for x in leaves))
        da64, dv64 = vjp64(jnp.asarray(g, jnp.float64))

    a = _t(leaves[0]).to(torch.bfloat16).requires_grad_()
    v = _t(leaves[1]).to(torch.bfloat16).requires_grad_()
    out = kernels.SegmentSoftmaxAttendFn.apply(a, v, _t(idx), m)
    out.backward(_t(g))
    assert out.dtype == torch.float32
    assert a.grad.dtype == v.grad.dtype == torch.bfloat16
    valid = (idx >= 0) & (idx < m)
    assert np.all(a.grad.float().numpy()[~valid] == 0.0)
    assert np.all(v.grad.float().numpy()[~valid] == 0.0)
    for name, got, jx, ref in (
            ("out", out.detach().numpy(), out_j, out64),
            ("dattn", a.grad.float().numpy()[valid], np.asarray(da_j)[valid],
             np.asarray(da64)[valid]),
            ("dvalues", v.grad.float().numpy()[valid],
             np.asarray(dv_j)[valid], np.asarray(dv64)[valid])):
        jx, ref = np.asarray(jx, np.float64), np.asarray(ref)
        scale = np.abs(ref).max()
        ulp = BF16_ULP * scale
        jax_err = np.abs(jx - ref).max()
        record_property(name, {
            "port_vs_jax": float(np.abs(got - jx).max() / scale),
            "jax_vs_f64": float(jax_err / scale),
            "port_vs_f64": float(np.abs(got - ref).max() / scale)})
        assert np.abs(got - ref).max() <= ulp, name
        assert np.abs(got - jx).max() <= jax_err + ulp, name


@pytest.mark.parametrize("dtypes", [
    (torch.float16, torch.float16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16)])
def test_segment_softmax_backward_refuses_other_dtypes_on_the_card(dtypes):
    """On CUDA tensors (fake ones: this host has no card) the backward
    wrapper takes attn and values both f32 or both bf16 and raises on any
    other pair before a launch, rather than widening them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    b, n, m, f = 2, 40, 7, 6
    name = "segment_softmax_attend_backward"
    before = kernels.launch_counts()[name]
    with FakeTensorMode():
        def t(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="cuda")
        with pytest.raises(TypeError, match="dtype"):
            kernels.segment_softmax_attend_backward(
                t(b, n, f, dtype=dtypes[0]), t(b, n, f, dtype=dtypes[1]),
                t(b, n, dtype=torch.int32), t(b, m, f), t(b, m, f), t(b, f),
                t(b, m, f), m)
    assert kernels.launch_counts()[name] == before


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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
