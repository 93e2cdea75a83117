"""The port's kernel plain versions vs the JAX package's Pallas kernels.

Each JAX kernel runs in Pallas ``interpret=True`` mode on the CPU (and,
where one exists, against its XLA fallback too); the port's wrappers take
their plain PyTorch versions because the tensors lie on the CPU. Inputs are
made with numpy from fixed seeds and handed to both packages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmr_agent_tpu.ops import pallas_kernels as pk
from cmr_agent_tpu.ops.scatter import segment_softmax_attend
from cmr_agent_tpu_torch.ops import kernels


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _softmax_attend_f64(attn, values, idx, m):
    """numpy f64 recomputation of the segment softmax-attend (global max,
    routed-out ids dropped, empty segments 0)."""
    a, v = attn.astype(np.float64), values.astype(np.float64)
    e = np.exp(a - a.max(axis=1, keepdims=True))
    b, _, f = a.shape
    sums = np.zeros((b, m, f))
    acc = np.zeros((b, m, f))
    for i in range(b):
        ok = (idx[i] >= 0) & (idx[i] < m)
        np.add.at(sums[i], idx[i][ok], e[i][ok])
        np.add.at(acc[i], idx[i][ok], e[i][ok] * v[i][ok])
    return acc / np.maximum(sums, 1e-30)


def _report_mismatch(which, got, want, exact):
    """Print what a failed comparison needs to name its cause: the
    assertion, the largest error and its index, each side against an f64
    recomputation, and the host's threading and vector path."""
    import os
    err = np.abs(got - want)
    at = np.unravel_index(np.argmax(err), err.shape)
    port_err = np.abs(got - exact).max()
    ref_err = np.abs(want - exact).max()
    tol = 1e-6 + 1e-5 * np.abs(exact)
    port_off = bool((np.abs(got - exact) > tol).any())
    ref_off = bool((np.abs(want - exact) > tol).any())
    side = {(True, False): "the port", (False, True): "the JAX side",
            (True, True): "both", (False, False): "neither"}[
        (port_off, ref_off)]
    print(f"[softmax_report] assertion={which} max_err={err.max():.3e} "
          f"at={tuple(int(i) for i in at)} got={got[at]!r} "
          f"want={want[at]!r} f64={exact[at]!r}")
    print(f"[softmax_report] port_vs_f64={port_err:.3e} "
          f"jax_vs_f64={ref_err:.3e} off={side}")
    print(f"[softmax_report] threads={torch.get_num_threads()} "
          f"cpu_capability={torch.backends.cpu.get_cpu_capability()} "
          f"xdist_worker={os.environ.get('PYTEST_XDIST_WORKER')}")
    print(torch.__config__.parallel_info())


def test_segment_softmax_attend_plain_matches_jax():
    """rtol 1e-5: both use the global max; sums are reordered (f32). On a
    mismatch the test prints which side an f64 recomputation finds off,
    then fails."""
    rng = np.random.default_rng(0)
    b, n, m, f = 2, 700, 37, 16
    attn = (rng.normal(size=(b, n, f)) * 3).astype(np.float32)
    values = rng.normal(size=(b, n, f)).astype(np.float32)
    idx = rng.integers(0, m - 5, size=(b, n)).astype(np.int32)  # 5 empty
    idx[:, :20] = m + 3                                         # out of range
    idx[:, 20:30] = -1
    got = kernels.segment_softmax_attend(_t(attn), _t(values), _t(idx), m)
    want = pk.segment_softmax_attend_fused(
        jnp.asarray(attn), jnp.asarray(values), jnp.asarray(idx), m,
        tile=128, interpret=True)
    try:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    except AssertionError:
        _report_mismatch("port vs the Pallas kernel (interpret)",
                         got.numpy(), np.asarray(want),
                         _softmax_attend_f64(attn, values, idx, m))
        raise
    assert np.all(got.numpy()[:, m - 5:] == 0.0)
    # the XLA fallback (per-segment max) on in-range ids agrees too
    ok = np.clip(idx, 0, m - 1)
    xla = np.stack([np.asarray(segment_softmax_attend(
        jnp.asarray(attn[i]), jnp.asarray(values[i]), jnp.asarray(ok[i]), m))
        for i in range(b)])
    got_ok = kernels.segment_softmax_attend(_t(attn), _t(values), _t(ok), m)
    try:
        np.testing.assert_allclose(got_ok.numpy(), xla, rtol=1e-5, atol=1e-6)
    except AssertionError:
        _report_mismatch("port vs the XLA fallback", got_ok.numpy(), xla,
                         _softmax_attend_f64(attn, values, ok, m))
        raise


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_plain_matches_jax(dtype):
    """Exact, out-of-range rows zero."""
    rng = np.random.default_rng(1)
    b, m, n, f = 2, 50, 300, 8
    table = rng.normal(size=(b, m, f)).astype(np.float32)
    idx = rng.integers(-3, m + 3, size=(b, n)).astype(np.int32)
    jt = jnp.asarray(table, jnp.dtype(dtype))
    want = np.asarray(pk.gather_rows_fused(jt, jnp.asarray(idx), tile=128,
                                           interpret=True).astype(jnp.float32))
    tt = _t(table).to(getattr(torch, dtype))
    got = kernels.gather_rows(tt, _t(idx)).float().numpy()
    np.testing.assert_array_equal(got, want)
    bad = (idx < 0) | (idx >= m)
    assert bad.any() and np.all(got[bad] == 0)


def test_knn_plain_matches_jax():
    """Same neighbour sets as the kernel in interpret mode and as the
    ``lax.top_k`` fallback (near-ties may reorder, sets must agree)."""
    rng = np.random.default_rng(2)
    b, n, k = 2, 300, 16
    xyz = (rng.normal(size=(b, n, 3)) * 5).astype(np.float32)
    query = xyz[:, :200]
    got = kernels.knn(_t(xyz), _t(query), k).numpy()
    want = np.asarray(pk.knn_fused(jnp.asarray(xyz), jnp.asarray(query), k,
                                   tile=128, interpret=True))
    assert got.dtype == np.int32 and got.shape == (b, 200, k)
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(want, -1))
    d = ((query[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    ref = np.argsort(d, axis=-1, kind="stable")[..., :k]
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(ref, -1))


def _raster_inputs(seed):
    rng = np.random.default_rng(seed)
    b, k, f, h, w = 2, 1024, 8, 6, 10
    pcT = (rng.normal(size=(b, 3, k)) * 2).astype(np.float32)
    pcT[:, 2] += 6.0
    pcT[:, 2, :40] = -3.0                     # behind the camera
    feat = rng.normal(size=(b, k, f)).astype(np.float32)
    counts = np.array([700, 300], np.int32)   # rows past counts: dropped tail
    feat[1, 900:] *= 40.0                     # large tail sets the int8 absmax
    K = np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1]], np.float32)
    yaw = np.array([0.2, -0.4])
    R = np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]] for a in yaw]).astype(np.float32)
    t = np.array([[0.5, 0.0, -0.3], [-0.2, 0.1, 0.4]], np.float32)
    A = K[None] @ R
    bv = (K[None] @ t[..., None])[..., 0]
    ab = np.concatenate([A.reshape(b, 9), bv], 1).astype(np.float32)
    return pcT, feat, ab, counts, h, w


@pytest.mark.parametrize("mode,atol", [("float32", 2e-5), ("bfloat16", 2e-2),
                                       ("int8", 1e-5)])
def test_raster_project_plain_matches_jax(mode, atol):
    """f32 within 2e-5, bf16 within bf16 rounding of the inputs; int8:
    counts exact and means within 1e-5 of the JAX int8 path."""
    pcT, feat, ab, counts, h, w = _raster_inputs(3)
    dt = {"float32": None, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[mode]
    tdt = {"float32": None, "bfloat16": torch.bfloat16,
           "int8": torch.int8}[mode]
    want_m, want_c = pk.segment_mean_count_image_project_fused(
        jnp.asarray(pcT), jnp.asarray(feat), jnp.asarray(ab),
        jnp.asarray(counts), h, w, tile=256, compute_dtype=dt, interpret=True)
    got_m, got_c = kernels.segment_mean_count_image_project(
        _t(pcT), _t(feat), _t(ab), _t(counts), h, w, compute_dtype=tdt)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_c.numpy().sum() > 0
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=atol)


def test_raster_project_plain_matches_composable_jax_path():
    """The same raster through the JAX package's composable
    project -> scatter_mean_image path (its CPU route)."""
    from cmr_agent_tpu.ops.geometry import frustum_mask, project_points
    from cmr_agent_tpu.ops.scatter import scatter_mean_image
    pcT, feat, ab, counts, h, w = _raster_inputs(4)
    A = ab[:, :9].reshape(-1, 3, 3)
    moved = np.einsum("bij,bjn->bni", A, pcT) + ab[:, None, 9:]
    # identity intrinsics: A, b already hold the camera
    proj = project_points(jnp.asarray(moved), jnp.eye(3)[None])
    valid = frustum_mask(proj, w, h) & (np.arange(pcT.shape[2])[None]
                                        < counts[:, None])
    pix = (jnp.round(proj[..., 1]).astype(jnp.int32) * w
           + jnp.round(proj[..., 0]).astype(jnp.int32))
    want = scatter_mean_image(jnp.asarray(feat), pix, valid, h, w)
    got, _ = kernels.segment_mean_count_image_project(
        _t(pcT), _t(feat), _t(ab), _t(counts), h, w)
    np.testing.assert_allclose(got.numpy().reshape(want.shape),
                               np.asarray(want), atol=2e-5)


def test_int8_quantisation_covers_rows_past_counts():
    """The absmax scale covers all K rows (the JAX package's behaviour,
    matched on purpose): a large dropped tail coarsens the valid rows."""
    _, feat, _, _, _, _ = _raster_inputs(3)
    _, scale = kernels.quantize_int8(_t(feat))
    np.testing.assert_allclose(scale.numpy(),
                               np.abs(feat).max(axis=1) / 127.0, rtol=1e-6)


def test_wrappers_route_cpu_tensors_to_plain_and_count_no_launch():
    kernels.reset_launch_counts()
    pcT, feat, ab, counts, h, w = _raster_inputs(5)
    kernels.segment_mean_count_image_project(_t(pcT), _t(feat), _t(ab),
                                             _t(counts), h, w)
    kernels.knn(_t(pcT.transpose(0, 2, 1).copy()), _t(pcT.transpose(0, 2, 1)
                                                      .copy()), 4)
    kernels.segment_sum_shared(_t(feat), torch.zeros(
        feat.shape[0], 2, feat.shape[1], dtype=torch.int32), 3)
    kernels.mask_compact_pack(torch.ones(pcT.shape[0], pcT.shape[2],
                                         dtype=torch.bool), _t(pcT), _t(feat),
                              4)
    ids = torch.zeros(feat.shape[:2], dtype=torch.int32)
    kernels.segment_sum_count_image_compact(_t(feat), ids, h, w, torch.int8)
    w0 = torch.ones(feat.shape[-1], 4)
    kernels.fused_dense_chain(_t(feat), [w0], [torch.zeros(4)], slopes=[0.2])
    kernels.fused_dense_chain_cn(_t(feat).transpose(1, 2).contiguous(), [w0],
                                 [torch.zeros(4)], slopes=[None])
    kernels.segment_sum_image(_t(feat), ids, h, w)
    assert kernels.launch_counts() == {
        "segment_softmax_attend": 0, "gather_rows": 0, "knn": 0,
        "segment_mean_count_image_project": 0, "segment_sum": 0,
        "segment_softmax_attend_backward": 0, "segment_mean_count_image": 0,
        "segment_sum_shared": 0, "mask_compact_pack": 0,
        "segment_sum_count_image_compact": 0, "fused_dense_chain": 0,
        "fused_dense_chain_cn": 0, "segment_sum_image": 0}
    meta = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError):
        kernels.gather_rows(meta[None], torch.zeros(1, 2, dtype=torch.int32))
