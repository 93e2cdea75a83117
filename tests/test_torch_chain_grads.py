"""Gradients of the port's kernels 8, 9 and 10 against the JAX package's
VJPs, on the CPU, and the chain kernel's weight packing.

``kernels.dense_chain`` (``DenseChainFn``) and
``kernels.SegmentSumCountImageCompactFn`` take their plain versions here,
because the tensors lie on the CPU; their backward rules are the ones the
card runs (autograd of the plain chain; the row gather of the sums'
gradient). The JAX side is ``jax.vjp`` of ``fused_dense_chain`` /
``fused_dense_chain_cn`` / ``segment_sum_count_image_compact`` in Pallas
``interpret=True`` mode, whose VJPs are ``jax.vjp`` of the pure-jnp chain
(pallas_kernels.py:1171-1179, :1371-1379) and the ``take_along_axis``
branch of the compact raster (:884-889). Inputs and cotangents come from
numpy with fixed seeds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmr_agent_tpu.ops import pallas_kernels as pk
from cmr_agent_tpu_torch.ops import kernels
from cmr_agent_tpu_torch.ops.scatter import scatter_mean_image

# (input width, layer widths, slopes, final slope, pooled width), as JAX's
# own chain tests build them
CHAINS = {
    "none": (8, (16, 24, 12), (0.2, None, 0.1), None, 0),
    "identity": (16, (24, 16), (0.2, None), 0.2, 0),
    "proj": (8, (16, 12), (0.2, None), 0.2, 0),
    "identity_split": (8, (16, 24), (0.2, None), 0.2, 16),
}


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _chain_inputs(residual: str, layout: str, seed: int):
    """x (``[B,N,C0]`` or ``[B,C0,N]``), weights, biases (the first per
    sample, the rest per channel), res_weight, res_bias, pooled; N = 300,
    not a multiple of the 128-point tile."""
    c0, widths, _, _, p = CHAINS[residual]
    rng = np.random.default_rng(seed)
    b, n = 2, 300
    dims = (c0,) + widths
    ws = [(rng.normal(size=(dims[i], dims[i + 1])) / np.sqrt(dims[i]))
          .astype(np.float32) for i in range(len(widths))]
    bs = [rng.normal(size=(b, widths[0])).astype(np.float32)] + [
        rng.normal(size=(w,)).astype(np.float32) for w in widths[1:]]
    rw = rb = pooled = None
    if residual == "proj":
        rw = (rng.normal(size=(c0, widths[-1])) / np.sqrt(c0)).astype(
            np.float32)
        rb = rng.normal(size=(b, widths[-1])).astype(np.float32)
    if residual == "identity_split":
        pooled = rng.normal(size=(b, p)).astype(np.float32)
    x = rng.normal(size=(b, n, c0)).astype(np.float32)
    if layout == "cn":
        x = np.ascontiguousarray(x.transpose(0, 2, 1))
    return x, ws, bs, rw, rb, pooled


def _chain_kw(residual: str, out_max: bool):
    _, _, slopes, final, _ = CHAINS[residual]
    return dict(slopes=slopes, residual=residual, final_slope=final,
                out_max=out_max)


def _torch_grads(layout, args, kw, cot):
    """The port's gradients of ``<outputs, cot>`` through
    ``kernels.dense_chain``: ``[dx, dW..., db..., dWr, dbr, dpooled]``
    (None where the argument is None)."""
    x, ws, bs, rw, rb, pooled = args
    leaves = [_t(x)] + [_t(w) for w in ws] + [_t(v) for v in bs] + [
        _t(rw), _t(rb), _t(pooled)]
    for t in leaves:
        if t is not None:
            t.requires_grad_()
    L = len(ws)
    outs = kernels.dense_chain(leaves[0], leaves[1:1 + L],
                               leaves[1 + L:1 + 2 * L], *leaves[1 + 2 * L:],
                               cn=layout == "cn", **kw)
    outs = outs if kw["out_max"] else (outs,)
    for o in outs:
        assert o.grad_fn is not None
    torch.autograd.backward(outs, [_t(c) for c in cot])
    return [None if t is None else t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("out_max", [False, True])
@pytest.mark.parametrize("residual", list(CHAINS))
@pytest.mark.parametrize("layout", ["nc", "cn"])
def test_dense_chain_grads_match_jax_vjp(layout, residual, out_max):
    """Every residual kind, both layouts, ``out_max`` on and off, f32 (as
    JAX's own VJP test, tests/test_fused_stacks.py:126-140), with a linear
    cotangent from numpy, so the gradients do not depend on the forward's
    rounding. Both sides differentiate their plain chain; they differ only
    in the f32 order of the sums over B x N = 600 rows (the weight
    gradients), hence rtol 1e-4 with atol 1e-5 of the largest entry."""
    seed = 11 + 2 * list(CHAINS).index(residual) + (layout == "cn")
    args = _chain_inputs(residual, layout, seed)
    kw = _chain_kw(residual, out_max)
    x, ws, bs, rw, rb, pooled = args
    jfn = pk.fused_dense_chain_cn if layout == "cn" else pk.fused_dense_chain

    def f(x_, ws_, bs_, rw_, rb_, p_):
        return jfn(x_, ws_, bs_, rw_, rb_, p_, **kw, tile=128,
                   interpret=True)

    jargs = (_j(x), tuple(_j(w) for w in ws), tuple(_j(v) for v in bs),
             _j(rw), _j(rb), _j(pooled))
    outs, vjp = jax.vjp(f, *jargs)
    outs = outs if out_max else (outs,)
    rng = np.random.default_rng(seed + 100)
    cot = [rng.normal(size=o.shape).astype(np.float32) for o in outs]
    jg = vjp(tuple(jnp.asarray(c) for c in cot) if out_max
             else jnp.asarray(cot[0]))
    want = [jg[0], *jg[1], *jg[2], jg[3], jg[4], jg[5]]
    got = _torch_grads(layout, args, kw, cot)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", ["proj", "identity_split"])
@pytest.mark.parametrize("layout", ["nc", "cn"])
def test_dense_chain_grads_equal_plain_autograd(layout, residual, dtype):
    """``DenseChainFn``'s backward is autograd of the plain chain on the
    saved inputs, so its gradients equal autograd of the plain version bit
    for bit, in bf16 too (weights and biases stay f32, as the modules
    fold them); ``out_max`` carries a gradient for both outputs."""
    args = _chain_inputs(residual, layout, 7)
    kw = _chain_kw(residual, True)
    dt = getattr(torch, dtype)
    plain = (kernels.fused_dense_chain_cn_plain if layout == "cn"
             else kernels.fused_dense_chain_plain)

    def leaves():
        x, ws, bs, rw, rb, pooled = args
        ts = [_t(x).to(dt)] + [_t(w) for w in ws] + [_t(v) for v in bs] + [
            _t(rw), _t(rb), _t(pooled)]
        return [None if t is None else t.requires_grad_() for t in ts]

    rng = np.random.default_rng(3)
    grads = []
    for fn in (kernels.dense_chain, plain):
        ts = leaves()
        L = len(args[1])
        extra = dict(cn=layout == "cn") if fn is kernels.dense_chain else {}
        out, mx = fn(ts[0], ts[1:1 + L], ts[1 + L:1 + 2 * L],
                     *ts[1 + 2 * L:], **kw, **extra)
        if not grads:
            cot = [torch.from_numpy(rng.normal(size=t.shape).astype(
                np.float32)).to(dt) for t in (out, mx)]
        torch.autograd.backward((out, mx), cot)
        grads.append([None if t is None else t.grad for t in ts])
    for g, w in zip(*grads):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype
            assert torch.equal(g, w)


def test_dense_chain_grads_only_where_asked():
    """Inputs that do not require grad get none, and the rest are
    unchanged by it; without any, the output has no ``grad_fn``."""
    args = _chain_inputs("proj", "nc", 5)
    kw = _chain_kw("proj", False)
    x, ws, bs, rw, rb, _ = (_t(a) if not isinstance(a, list)
                            else [_t(v) for v in a] for a in args)
    assert kernels.dense_chain(x, ws, bs, rw, rb, **kw).grad_fn is None
    xg = x.clone().requires_grad_()
    w0 = ws[0].clone().requires_grad_()
    out = kernels.dense_chain(xg, [w0, ws[1]], bs, rw, rb, **kw)
    cot = torch.from_numpy(np.random.default_rng(0).normal(
        size=out.shape).astype(np.float32))
    out.backward(cot)
    xa = x.clone().requires_grad_()
    wa = ws[0].clone().requires_grad_()
    kernels.fused_dense_chain_plain(xa, [wa, ws[1]], bs, rw, rb,
                                    **kw).backward(cot)
    assert torch.equal(xg.grad, xa.grad) and torch.equal(w0.grad, wa.grad)
    assert all(t.grad is None for t in (ws[1], rw, rb, *bs))


@pytest.mark.parametrize("shape", [(3, 64), (5, 64), (128, 128), (40, 100),
                                   (64, 12)])
def test_pack_chain_weights_bf16_fragment_order(shape):
    """The bf16 buffer holds each matrix zero-padded to 16, 32, 64 or 128
    in both dims, in mma.m16n8k16 B-fragment order: lane ``4 g + t`` of
    (k-tile ``kt``, n-tile ``nt``) holds ``W[16 kt + 8 r + 2 t + e, 8 nt + g]`` in half
    ``e`` of register ``r``; the matrices follow one another at the offsets
    the kernel computes (``kp_in * kp_out`` elements each). Exact."""
    k, n = shape
    rng = np.random.default_rng(k * 1000 + n)
    mats = [rng.normal(size=(k, n)).astype(np.float32),
            rng.normal(size=(n, 16)).astype(np.float32)]
    buf = kernels.pack_chain_weights([_t(m) for m in mats],
                                     torch.bfloat16).float().numpy()
    off = 0
    for m in mats:
        kp, np_ = (next(p for p in (16, 32, 64, 128) if c <= p)
                   for c in m.shape)
        frag = buf[off:off + kp * np_].reshape(kp // 16, np_ // 8, 32, 2, 2)
        off += kp * np_
        want = np.zeros((kp, np_), np.float32)
        want[:m.shape[0], :m.shape[1]] = torch.from_numpy(m).to(
            torch.bfloat16).float().numpy()
        kt, nt, lane, r, e = np.meshgrid(*(np.arange(s) for s in frag.shape),
                                         indexing="ij")
        g, t = lane // 4, lane % 4
        np.testing.assert_array_equal(
            frag, want[16 * kt + 8 * r + 2 * t + e, 8 * nt + g])
    assert off == buf.size


def test_pack_chain_weights_f32_rows():
    """The f32 buffer holds each matrix row-major with its columns padded
    to 64, or to 128 past 64, in f32. Exact."""
    rng = np.random.default_rng(4)
    mats = [rng.normal(size=s).astype(np.float32)
            for s in ((5, 64), (64, 100), (100, 7))]
    buf = kernels.pack_chain_weights([_t(m) for m in mats],
                                     torch.float32).numpy()
    off = 0
    for m in mats:
        k, n = m.shape
        width = 64 if n <= 64 else 128
        got = buf[off:off + k * width].reshape(k, width)
        off += k * width
        np.testing.assert_array_equal(got[:, :n], m)
        assert np.all(got[:, n:] == 0)
    assert off == buf.size


@pytest.mark.parametrize("compute", ["float32", "bfloat16", "int8"])
def test_compact_raster_grad_matches_jax_vjp(compute):
    """Kernel 8's gradient is the row gather of the sums' gradient, zero
    for routed-out ids, the input's rounding (bf16) or quantisation (int8)
    differentiated as the identity, counts carrying none: equal to JAX's
    ``take_along_axis`` VJP (interpret mode) in every compute dtype.
    Exact."""
    rng = np.random.default_rng(21)
    b, n, f, h, w = 2, 700, 8, 6, 12
    data = rng.normal(size=(b, n, f)).astype(np.float32)
    ids = rng.integers(-10, h * w + 20, size=(b, n)).astype(np.int32)
    g = rng.normal(size=(b, h * w, f)).astype(np.float32)
    jdt = {"float32": None, "bfloat16": jnp.bfloat16,
           "int8": jnp.int8}[compute]
    tdt = {"float32": None, "bfloat16": torch.bfloat16,
           "int8": torch.int8}[compute]
    _, vjp = jax.vjp(lambda d: pk.segment_sum_count_image_compact(
        d, jnp.asarray(ids), h, w, 512, 128, jdt, True), jnp.asarray(data))
    (want,) = vjp((jnp.asarray(g), jnp.zeros((b, h * w), jnp.float32)))
    d = _t(data).requires_grad_()
    sums, counts = kernels.SegmentSumCountImageCompactFn.apply(
        d, _t(ids), h, w, tdt)
    assert sums.grad_fn is not None and not counts.requires_grad
    sums.backward(_t(g))
    np.testing.assert_array_equal(d.grad.numpy(), np.asarray(want))
    routed_out = (ids < 0) | (ids >= h * w)
    assert routed_out.any() and np.all(d.grad.numpy()[routed_out] == 0)


def test_compact_mean_image_grad_equals_flat():
    """``scatter_mean_image`` differentiates in "compact" mode as in
    "flat": the same means, and the same gradient, within 1e-6 (the two
    divide by the counts at different points)."""
    rng = np.random.default_rng(22)
    b, n, f, h, w = 2, 500, 6, 5, 9
    feat = rng.normal(size=(b, n, f)).astype(np.float32)
    pix = rng.integers(0, h * w, size=(b, n)).astype(np.int64)
    valid = rng.random(size=(b, n)) > 0.3
    g = _t(rng.normal(size=(b, h, w, f)).astype(np.float32))
    out = {}
    for mode in ("flat", "compact"):
        x = _t(feat).requires_grad_()
        img = scatter_mean_image(x, _t(pix), _t(valid), h, w, mode=mode)
        img.backward(g)
        out[mode] = (img.detach(), x.grad)
    for a, c in zip(out["flat"], out["compact"]):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-6)
