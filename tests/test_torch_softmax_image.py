"""The segment softmax-attend (kernel 1) and the pixel-id raster (kernel
6a): their plain versions (what ``kernels.segment_softmax_attend`` and
``kernels.segment_mean_count_image`` take for CPU tensors) against the JAX
package's Pallas kernels in interpret mode, at the inputs the CUDA
kernels' bucketing and bands are sensitive to. ``chip_smoke.py`` holds the
kernels to these plain versions on the card on the same kinds of input
(phase 17).

Inputs are seeded numpy draws handed to both packages. Tolerances: the
softmax's output and sums rtol 1e-5 atol 1e-6 (f32 sums in another order,
and the plain version's exp is correctly rounded where the JAX one need not
be), its max exact; bf16 operands equal the f32 call on the widened
tensors bit for bit; bf16 gradients within one bf16 rounding (rtol 2^-7,
atol 1e-6), both sides rounding an f32 gradient to bf16 once; the raster's
counts exact, f32 / bf16 means rtol / atol 1e-6 (f32 sums in another
order), int8 means equal (the same scale, exact integer sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmr_agent_tpu.ops import pallas_kernels as pk
from cmr_agent_tpu_torch.ops import kernels

TILE = 128


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# kernel 1: segment softmax-attend
# --------------------------------------------------------------------------

SOFTMAX_KINDS = ("skew", "one_segment", "empty_ends", "all_routed_out",
                 "minus_one_and_past_m", "underflow")
# (N, F, M): N a multiple of no tile, F = 3, 64 (the model's) and 66
SOFTMAX_SHAPES = ((77, 3, 19), (77, 66, 19), (1000, 3, 37), (1000, 64, 37),
                  (1000, 66, 37))


def _softmax_case(kind, b, n, f, m, seed):
    """``(attn [b, n, f], values [b, n, f], idx [b, n], M)`` of one kind."""
    rng = np.random.default_rng(seed)
    attn = (rng.normal(size=(b, n, f)) * 3).astype(np.float32)
    values = rng.normal(size=(b, n, f)).astype(np.float32)
    idx = rng.integers(0, m, size=(b, n)).astype(np.int32)
    if kind == "skew":                   # one segment takes 90% of the rows
        idx[rng.random((b, n)) < 0.9] = m // 2
    elif kind == "one_segment":
        idx, m = rng.integers(-1, 2, size=(b, n)).astype(np.int32), 1
    elif kind == "empty_ends":
        idx = rng.integers(2, m - 2, size=(b, n)).astype(np.int32)
    elif kind == "all_routed_out":
        idx[0] = -1
        idx[1] = m + rng.integers(0, 5, size=n)
    elif kind == "minus_one_and_past_m":
        idx = rng.integers(-1, m + 3, size=(b, n)).astype(np.int32)
    elif kind == "underflow":
        # segment 3's logits lie 1000 below the rest of their sample's:
        # exp underflows to 0 in both packages, so its output is 0
        idx[:, :5] = 3
        attn[idx == 3] -= 1000.0
    return attn, values, idx, m


@pytest.mark.parametrize("n,f,m", SOFTMAX_SHAPES)
@pytest.mark.parametrize("kind", SOFTMAX_KINDS)
def test_segment_softmax_plain_matches_pallas_interpret(kind, n, f, m):
    """Output, sums and max against the Pallas kernel's forward and its
    residuals (``_fwd``); the segments that must be 0 are 0."""
    attn, values, idx, m = _softmax_case(kind, 2, n, f, m, seed=n + 7 * f)
    want_out, (_, _, _, _, want_sums, want_gmax) = pk._fwd(
        jnp.asarray(attn), jnp.asarray(values), jnp.asarray(idx), m, TILE,
        True)
    out, sums, gmax = kernels.segment_softmax_attend(
        _t(attn), _t(values), _t(idx), m, return_stats=True)
    assert out.shape == sums.shape == (2, m, f) and gmax.shape == (2, f)
    assert out.dtype == sums.dtype == gmax.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(sums.numpy(), np.asarray(want_sums),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(gmax.numpy(), np.asarray(want_gmax)[:, 0])
    landed = np.zeros((2, m), bool)
    for s in range(2):
        ok = (idx[s] >= 0) & (idx[s] < m)
        landed[s, idx[s][ok]] = True
    assert not out.numpy()[~landed].any() and not sums.numpy()[~landed].any()
    if kind == "underflow":
        assert landed[:, 3].all()
        assert not out.numpy()[:, 3].any()
        assert not np.asarray(want_out)[:, 3].any()


@pytest.mark.parametrize("n,f,m", SOFTMAX_SHAPES)
def test_segment_softmax_plain_bf16_equals_widened(n, f, m):
    """bf16 operands give the bits of the f32 call on the widened tensors
    (output, sums and max, all f32), as the kernel widens in registers."""
    attn, values, idx, m = _softmax_case("minus_one_and_past_m", 2, n, f, m,
                                         seed=3 * n + f)
    a16, v16 = _t(attn).bfloat16(), _t(values).bfloat16()
    got = kernels.segment_softmax_attend(a16, v16, _t(idx), m,
                                         return_stats=True)
    want = kernels.segment_softmax_attend(a16.float(), v16.float(), _t(idx),
                                          m, return_stats=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)


@pytest.mark.parametrize("kind", ("minus_one_and_past_m", "skew"))
def test_segment_softmax_fn_bf16_gradients_match_jax_vjp(kind):
    """``SegmentSoftmaxAttendFn`` on bf16 leaves: gradients in bf16 (the
    VJP of the widening cast), within one bf16 rounding of ``jax.vjp`` of
    ``astype(f32)`` and the Pallas kernel in interpret mode on the rows in
    range; routed-out rows get exactly 0."""
    attn, values, idx, m = _softmax_case(kind, 2, 300, 16, 23, seed=11)
    g = np.random.default_rng(12).normal(size=(2, m, 16)).astype(np.float32)

    def fn(a, v):
        return pk.segment_softmax_attend_fused(
            a.astype(jnp.float32), v.astype(jnp.float32), jnp.asarray(idx),
            m, TILE, True)
    out_j, vjp = jax.vjp(fn, jnp.asarray(attn, jnp.bfloat16),
                         jnp.asarray(values, jnp.bfloat16))
    want_da, want_dv = (np.asarray(x.astype(jnp.float32))
                        for x in vjp(jnp.asarray(g)))
    a = _t(attn).bfloat16().requires_grad_()
    v = _t(values).bfloat16().requires_grad_()
    out = kernels.SegmentSoftmaxAttendFn.apply(a, v, _t(idx), m)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-6)
    out.backward(_t(g))
    assert a.grad.dtype == v.grad.dtype == torch.bfloat16
    # (the interpret-mode VJP gathers routed-out rows' residuals out of
    # bounds, NaN; only the rows in range are compared, as
    # test_torch_train_kernels.py compares them)
    routed = (idx < 0) | (idx >= m)
    for got, want in ((a.grad, want_da), (v.grad, want_dv)):
        got = got.float().numpy()
        np.testing.assert_allclose(got[~routed], want[~routed],
                                   rtol=2.0 ** -7, atol=1e-6)
        assert not got[routed].any()


# --------------------------------------------------------------------------
# kernel 6a: pixel-id raster, mean + count
# --------------------------------------------------------------------------

RASTER_KINDS = ("counts_0", "one_pixel", "all_routed_out", "every_pixel",
                "odd_frame_37x101", "zero_channel")
RASTER_TOL = {"float32": (1e-6, 1e-6), "bfloat16": (1e-6, 1e-6),
              "int8": (0.0, 0.0)}


def _raster_case(kind, seed=5):
    """``(data [2, K, F], ids [2, K], h, w)``: valid-first rows, a third
    of the valid prefix outside the frame (``h*w``), a tail routed out by
    ``h*w``, above it and by -1, large rows in the tail (they set the int8
    scale, as the JAX package's absmax covers all K rows)."""
    rng = np.random.default_rng(seed)
    h, w, k, f = 8, 16, 600, 24
    if kind == "odd_frame_37x101":
        h, w = 37, 101
    hw = h * w
    data = rng.normal(size=(2, k, f)).astype(np.float32)
    counts = np.array([k // 3, k - 40])
    row = np.arange(k)[None, :]
    lands = (row < counts[:, None]) & (rng.random((2, k)) > 1 / 3)
    ids = np.where(lands, rng.integers(0, hw, size=(2, k)), hw)
    ids[:, -20:-10] = hw + 5
    ids[:, -10:] = -1
    data[:, -30:] *= 40.0
    if kind == "counts_0":
        ids[0] = hw                    # sample 0: no row lands
    elif kind == "one_pixel":
        ids[:] = 2 * w + 3             # every row on one pixel
    elif kind == "all_routed_out":
        ids[0], ids[1] = -1, hw + rng.integers(0, 3, size=k)
    elif kind == "every_pixel":
        ids = np.tile(np.arange(hw), k // hw + 1)[None, :k].repeat(2, 0)
        ids[1] = ids[1, ::-1]
    elif kind == "zero_channel":
        data[..., 2] = 0.0             # scale = 1e-12 / 127
        data[1, :, 5] = 0.0
    return data, ids.astype(np.int32), h, w


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind", RASTER_KINDS)
def test_pixel_id_raster_plain_matches_pallas_interpret(kind, mode):
    """Counts exact; means within ``RASTER_TOL[mode]`` of the flat Pallas
    kernel (``segment_mean_count_image_fused(factored=False)``) in
    interpret mode, in the data's own dtype f32 or bf16."""
    data, ids, h, w = _raster_case(kind)
    jdt = {"float32": None, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[mode]
    tdt = {"float32": None, "bfloat16": torch.bfloat16,
           "int8": torch.int8}[mode]
    want_m, want_c = pk.segment_mean_count_image_fused(
        jnp.asarray(data), jnp.asarray(ids), h, w, tile=TILE, factored=False,
        compute_dtype=jdt, interpret=True)
    got_m, got_c = kernels.segment_mean_count_image(_t(data), _t(ids), h, w,
                                                    tdt)
    assert got_m.shape == (2, h * w, data.shape[-1])
    assert got_m.dtype == got_c.dtype == torch.float32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    rtol, atol = RASTER_TOL[mode]
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=rtol,
                               atol=atol)
    landed = got_c.numpy().sum(axis=1)
    hw = h * w
    want_landed = ((ids >= 0) & (ids < hw)).sum(axis=1)
    np.testing.assert_array_equal(landed, want_landed)
    if kind == "counts_0":
        assert landed[0] == 0 and not got_m.numpy()[0].any()
    if kind == "one_pixel":
        assert (got_c.numpy()[:, 2 * w + 3] == landed).all()
    if kind == "all_routed_out":
        assert not got_c.numpy().any() and not got_m.numpy().any()
    if kind == "every_pixel":
        assert (got_c.numpy() > 0).all()
    if kind == "zero_channel":
        assert not got_m.numpy()[..., 2].any()
        assert not got_m.numpy()[1, :, 5].any()


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_pixel_id_raster_bf16_data_read_as_given(mode):
    """bf16 data in any mode gives the means of its f32 widening (the
    kernel reads bf16 as given and widens in registers)."""
    data, ids, h, w = _raster_case("every_pixel", seed=8)
    tdt = {"float32": None, "bfloat16": torch.bfloat16,
           "int8": torch.int8}[mode]
    d16 = _t(data).bfloat16()
    got = kernels.segment_mean_count_image(d16, _t(ids), h, w, tdt)
    want = kernels.segment_mean_count_image(d16.float(), _t(ids), h, w, tdt)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
