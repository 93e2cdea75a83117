"""The plain versions of the exact knn (kernel 3) and the projection-fused
observation raster (kernel 4) against the JAX package, at the edge cases
their CUDA kernels must reproduce.

The JAX kernels run in Pallas ``interpret=True`` mode on the CPU (the knn
also through its ``lax.top_k`` fallback); the port's wrappers take their
plain versions because the tensors lie on the CPU. Inputs are made with
numpy from fixed seeds and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmr_agent_tpu.ops import pallas_kernels as pk
from cmr_agent_tpu.ops.sampling import knn_indices
from cmr_agent_tpu_torch.ops import kernels


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# kernel 3: exact knn, neighbours in full order
# --------------------------------------------------------------------------

def _knn_inputs(kind: str, seed: int):
    """``(xyz [B,N,3], query [B,M,3])``: coordinates on a 1/8 grid in
    [-2, 2], where every distance is exact in f32 in any order, so both
    rankings (and their ties, to the lower index) are the exact ones."""
    rng = np.random.default_rng(seed)

    def grid(*shape):
        return (rng.integers(-16, 17, size=shape) / 8).astype(np.float32)
    if kind == "grid":
        xyz = grid(2, 300, 3)
        return xyz, xyz[:, :100]
    if kind == "duplicates":
        # every site three times over, at scattered indices
        sites = grid(2, 100, 3)
        xyz = np.concatenate([sites, sites, sites], axis=1)
        perm = rng.permutation(300)
        return xyz[:, perm], grid(2, 50, 3)
    if kind == "m_ne_n":
        return grid(2, 333, 3), grid(2, 71, 3)
    if kind == "n4096":
        return grid(1, 4096, 3), grid(1, 6, 3)
    raise ValueError(kind)


KNN_CASES = [("grid", 1), ("grid", 4), ("grid", 16), ("grid", 32),
             ("duplicates", 8), ("duplicates", 32), ("m_ne_n", 16),
             ("n4096", 16), ("n4096", 32)]


@pytest.mark.parametrize("kind,k", KNN_CASES,
                         ids=[f"{kind}-k{k}" for kind, k in KNN_CASES])
def test_knn_plain_matches_jax_in_full_order(kind, k):
    """Exact: the same neighbours in the same order as the Pallas kernel
    (interpret mode) and the ``lax.top_k`` fallback, ties to the lower
    index."""
    xyz, query = _knn_inputs(kind, seed=len(kind) * 100 + k)
    got = kernels.knn(_t(xyz), _t(query), k).numpy()
    pallas = np.asarray(pk.knn_fused(jnp.asarray(xyz), jnp.asarray(query), k,
                                     tile=128, interpret=True))
    top_k = np.asarray(knn_indices(jnp.asarray(xyz), jnp.asarray(query), k,
                                   use_pallas=False))
    assert got.dtype == np.int32 and got.shape == query.shape[:2] + (k,)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, top_k)
    # the exact ranking: squared distance, then index
    d = ((query[:, :, None].astype(np.float64)
          - xyz[:, None].astype(np.float64)) ** 2).sum(-1)
    ref = np.argsort(d, axis=-1, kind="stable")[..., :k]
    np.testing.assert_array_equal(got, ref)
    if kind == "duplicates":
        # a site's copies follow one another, lower index first
        dd = np.take_along_axis(d, got.astype(np.int64), -1)
        tie = dd[..., 1:] == dd[..., :-1]
        assert tie.any() and (got[..., 1:] > got[..., :-1])[tie].all()


# --------------------------------------------------------------------------
# kernel 4: projection-fused raster, f32 / bf16 / int8
# --------------------------------------------------------------------------

K = 256          # rows a sample, a multiple of the Pallas tile below
TILE = 128


def _camera(b, h, w, rng):
    """``ab [B, 12]``: a yawed pinhole camera centred on the frame."""
    cam = np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1]], np.float32)
    yaw = rng.uniform(-0.3, 0.3, size=b)
    R = np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]] for a in yaw])
    t = rng.normal(size=(b, 3)) * 0.3
    A = cam[None] @ R
    bv = (cam[None] @ t[..., None])[..., 0]
    return np.concatenate([A.reshape(b, 9), bv], 1).astype(np.float32)


IDENTITY = np.array([1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0], np.float32)


def _raster_case(kind: str):
    """``(pcT [2,3,K], feat [2,K,F], ab [2,12], counts [2], h, w)``."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    b, f, h, w = 2, 8, 6, 10
    if kind == "f1":
        f = 1
    elif kind == "f66":
        f = 66
    elif kind == "h5":
        h, w = 5, 12
    pcT = (rng.normal(size=(b, 3, K)) * 2).astype(np.float32)
    pcT[:, 2] += 6.0
    pcT[:, 2, :20] = -3.0                       # behind the camera
    feat = rng.normal(size=(b, K, f)).astype(np.float32)
    ab = _camera(b, h, w, rng)
    counts = np.array([200, 150], np.int32)
    if kind == "counts_0_and_K":
        counts = np.array([0, K], np.int32)
    elif kind == "one_pixel":
        pcT = np.tile(np.array([3.0, 2.0, 1.0], np.float32)[None, :, None],
                      (b, 1, K))
        # multiples of 1/64: every sum exact, in any order
        feat = (rng.integers(-256, 257, size=(b, K, f)) / 64).astype(
            np.float32)
        ab = np.tile(IDENTITY, (b, 1))
        counts = np.array([K, K - 5], np.int32)
    elif kind == "boundaries":
        # the last column and row, half pixels (round half to even), just
        # outside the frame on either side; z = 1 keeps x, y exact
        xs = np.array([0, w - 1, w - 1 + 1e-3, w - 0.5, -0.25, -1e-6,
                       0.5, 1.5, 2.5, w - 1.5], np.float32)
        ys = np.array([0, h - 1, h - 1 + 1e-3, h - 0.5, -0.25, 0.5, 1.5,
                       2.5], np.float32)
        pcT = np.stack([rng.choice(xs, size=(b, K)),
                        rng.choice(ys, size=(b, K)),
                        np.ones((b, K))], 1).astype(np.float32)
        ab = np.tile(IDENTITY, (b, 1))
        counts = np.array([K, K - 17], np.int32)
    elif kind == "tiny_z":
        # |z| < 1e-10 (divided by 1e-10 instead; lands at x = y = 0 only
        # where z > 0) and z <= 0 (dropped)
        zs = np.array([1e-11, -1e-11, 0.0, -0.0, 1e-12, -1.0, 3e-11],
                      np.float32)
        pick = rng.random(size=(b, K)) < 0.5
        pcT[:, 0] = np.where(pick, 0.0, pcT[:, 0])
        pcT[:, 1] = np.where(pick, 0.0, pcT[:, 1])
        pcT[:, 2] = np.where(pick, rng.choice(zs, size=(b, K)), pcT[:, 2])
        ab = np.tile(IDENTITY, (b, 1))
        ab[:, 9], ab[:, 10] = 0.0, 0.0
        counts = np.array([K, K], np.int32)
    elif kind == "zero_channel":
        feat[..., 2] = 0.0                      # scale = 1e-12 / 127
        feat[1, :, 5] = 0.0
    feat[1, K - 30:] *= 40.0                    # large rows past counts
    return pcT, feat, ab, counts, h, w


RASTER_KINDS = ["counts_0_and_K", "one_pixel", "boundaries", "tiny_z", "f1",
                "f66", "zero_channel", "h5"]
# means tolerance (rtol, atol) by mode: f32 sums differ from the Pallas
# one-hot matmul only in their order (an f32 ulp or two); bf16 rounds the
# same inputs to bf16 on both sides and sums in f32 likewise; int8
# quantises both sides with the same scale and sums exactly
RASTER_TOL = {"float32": (1e-6, 1e-6), "bfloat16": (1e-6, 1e-6),
              "int8": (0.0, 0.0)}


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind", RASTER_KINDS)
def test_raster_project_plain_matches_jax_edges(kind, mode):
    """Counts exact; means within ``RASTER_TOL[mode]`` of the Pallas
    kernel in interpret mode (int8: equal)."""
    pcT, feat, ab, counts, h, w = _raster_case(kind)
    jdt = {"float32": None, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[mode]
    tdt = {"float32": None, "bfloat16": torch.bfloat16,
           "int8": torch.int8}[mode]
    want_m, want_c = pk.segment_mean_count_image_project_fused(
        jnp.asarray(pcT), jnp.asarray(feat), jnp.asarray(ab),
        jnp.asarray(counts), h, w, tile=TILE, compute_dtype=jdt,
        interpret=True)
    got_m, got_c = kernels.segment_mean_count_image_project(
        _t(pcT), _t(feat), _t(ab), _t(counts), h, w, compute_dtype=tdt)
    assert got_m.shape == (2, h * w, feat.shape[-1])
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    rtol, atol = RASTER_TOL[mode]
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=rtol,
                               atol=atol)
    landed = got_c.numpy().sum(axis=1)
    if kind == "counts_0_and_K":
        assert landed[0] == 0 and landed[1] > 0
    if kind == "one_pixel":
        assert landed.tolist() == [K, K - 5]
        assert (got_c.numpy()[:, 2 * w + 3] == landed).all()
        if mode == "float32":  # exact sums: bit-equal
            np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    if kind == "boundaries":
        # half pixels round to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
        ids = kernels._project_pixels(_t(pcT), _t(ab), _t(counts), h, w)
        x, ok = pcT[:, 0], ids.numpy() < h * w
        col = ids.numpy() % w
        for v, want in ((0.5, 0), (1.5, 2), (2.5, 2), (w - 1, w - 1),
                        (w - 1.5, w - 2)):
            sel = ok & (x == np.float32(v))
            assert sel.any() and (col[sel] == want).all(), v
        for v in (w - 1 + 1e-3, w - 0.5, -0.25, -1e-6):
            assert not (ok & (x == np.float32(v))).any(), v
    if kind == "tiny_z":
        z = pcT[:, 2]
        ids = kernels._project_pixels(_t(pcT), _t(ab), _t(counts), h, w)
        ids = ids.numpy()
        assert (ids[(z > 0) & (np.abs(z) < 1e-10)] == 0).all()
        assert (ids[z <= 0] == h * w).all()
    if kind == "zero_channel":
        assert not got_m.numpy()[..., 2].any()
        if mode == "int8":
            _, scale = kernels.quantize_int8(_t(feat))
            np.testing.assert_array_equal(
                scale.numpy()[:, 2], np.float32(1e-12) / np.float32(127))


def test_int8_scale_is_the_ieee_quotient():
    """``quantize_int8`` divides the clamped absmax by 127 with one IEEE
    rounding on every device (a tensor divisor: PyTorch's CUDA division by
    a Python scalar multiplies by the reciprocal instead); the CUDA kernel
    computes the same quotient."""
    rng = np.random.default_rng(9)
    feat = (rng.normal(size=(3, 40, 17)) * rng.uniform(
        0.01, 100, size=(3, 1, 17))).astype(np.float32)
    _, scale = kernels.quantize_int8(_t(feat))
    absmax = np.maximum(np.abs(feat).max(axis=1), np.float32(1e-12))
    np.testing.assert_array_equal(scale.numpy(), absmax / np.float32(127.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
