"""The compacting raster (kernel 8) and the mask-pack compaction (kernel
11) of the port against the JAX package's, on the CPU, and the kernel
library's C interface against the ctypes signatures that call it.

The port's plain versions (the wrappers take them for CPU tensors) are
held against the Pallas kernels in ``interpret=True`` mode on inputs made
with numpy from fixed seeds. The C entry points are compiled only where
the card is, so a parameter list that disagrees with ``_SIGNATURES`` would
only show there; the last tests parse ``csrc/*.cu`` and compare.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmr_agent_tpu.ops import pallas_kernels as pk
from cmr_agent_tpu_torch.ops import build, kernels

H, W = 8, 16
HW = H * W


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# kernel 8: the compacting raster
# --------------------------------------------------------------------------

def _compact_case(kind: str):
    """``(data [2,N,8] f32, ids [2,N] int32)`` of one id layout: ids in
    random order with a third routed out both ways (id < 0, id >= h*w) at
    N = 1024 (two JAX tiles); the same at N = 777 (not a multiple of the
    tile); every id routed out; every row on one pixel (rows on a 1/64
    grid, so that a pixel of 1300 rows sums exactly in any order); ids in
    descending order."""
    rng = np.random.default_rng(COMPACT_CASES.index(kind))
    n = {"shuffled": 1024, "ragged": 777, "all_routed_out": 600,
         "one_pixel": 1300, "reverse": 900}[kind]
    data = rng.normal(size=(2, n, 8)).astype(np.float32)
    ids = rng.integers(-HW // 3, HW + HW // 3, size=(2, n)).astype(np.int32)
    if kind == "all_routed_out":
        ids = np.where(rng.random((2, n)) < 0.5, -1, HW + 5).astype(np.int32)
    elif kind == "one_pixel":
        data = rng.integers(-256, 257, size=(2, n, 8)).astype(np.float32) / 64
        ids = np.full((2, n), 37, np.int32)
    elif kind == "reverse":
        ids = np.sort(ids, axis=1)[:, ::-1].copy()
    return data, ids


COMPACT_CASES = ("shuffled", "ragged", "all_routed_out", "one_pixel",
                 "reverse")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", COMPACT_CASES)
def test_compact_raster_plain_matches_jax_cases(kind, dtype):
    """Sums within rtol 1e-5 atol 1e-5 (both round the rows to ``dtype``
    once and sum in f32, in other orders); counts exact."""
    data, ids = _compact_case(kind)
    jdt = None if dtype == "float32" else jnp.bfloat16
    want_s, want_c = pk.segment_sum_count_image_compact(
        jnp.asarray(data), jnp.asarray(ids), H, W, tile=512,
        compute_dtype=jdt, interpret=True)
    tdt = None if dtype == "float32" else torch.bfloat16
    got_s, got_c = kernels.segment_sum_count_image_compact(
        _t(data), _t(ids), H, W, tdt)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)
    landed = int(((ids >= 0) & (ids < HW)).sum())
    assert got_c.sum() == landed
    if kind == "all_routed_out":
        assert landed == 0 and not got_s.any()
    elif kind == "one_pixel":
        assert got_c[:, 37].tolist() == [data.shape[1]] * 2


@pytest.mark.parametrize("skew", [0.6, 0.95])
def test_compact_raster_int8_equals_the_flat_int8_raster(skew):
    """In int8 the port's compacting raster quantises over all N rows as
    its flat raster does: on ids where ``skew`` of the rows land on one
    pixel, its sums over ``max(count, 1)`` equal the flat raster's means
    bit for bit, its counts the flat raster's. (The JAX compacting raster
    truncates in int8, test_torch_rasters.py; so this case is held against
    the port's own flat raster.)"""
    rng = np.random.default_rng(int(skew * 100))
    b, n, f = 2, 1100, 8
    data = (3.0 * rng.normal(size=(b, n, f))).astype(np.float32)
    ids = rng.integers(-5, HW + 20, size=(b, n)).astype(np.int32)
    ids[rng.random((b, n)) < skew] = 77
    sums, cnt = kernels.segment_sum_count_image_compact(_t(data), _t(ids), H,
                                                        W, torch.int8)
    means, counts = kernels.segment_mean_count_image(_t(data), _t(ids), H, W,
                                                     torch.int8)
    assert torch.equal(cnt, counts) and cnt[:, 77].min() > skew * n * 0.9
    assert torch.equal(sums / cnt.clamp_min(1.0)[..., None], means)


# --------------------------------------------------------------------------
# kernel 11: the mask-pack compaction
# --------------------------------------------------------------------------

N_PACK, K_PACK, BLOCK = 512, 256, 128


def _pack_mask(kind: str, rng):
    """``(mask [2, 512] bool, k)``: counts below, at and above k = 256 (the
    highest indices dropped), one sample below and one above, an empty
    mask, a full mask, and k = 768 > N."""
    b, n = 2, N_PACK
    if kind == "below":
        return rng.random((b, n)) < 0.3, K_PACK
    if kind == "above":
        return rng.random((b, n)) < 0.8, K_PACK
    if kind == "mixed":
        return rng.random((b, n)) < np.array([[0.3], [0.8]]), K_PACK
    if kind == "at":
        mask = np.zeros((b, n), bool)
        for row in mask:
            row[rng.choice(n, K_PACK, replace=False)] = True
        return mask, K_PACK
    if kind == "empty":
        return np.zeros((b, n), bool), K_PACK
    if kind == "full":
        return np.ones((b, n), bool), K_PACK
    assert kind == "k_above_n"
    return rng.random((b, n)) < 0.5, 3 * N_PACK // 2 + BLOCK


PACK_CASES = [(kind, "float32", 8) for kind in (
    "below", "at", "above", "mixed", "empty", "full", "k_above_n")] + [
    ("above", "bfloat16", 8), ("mixed", "bfloat16", 8),
    ("above", "bfloat16", 5), ("k_above_n", "bfloat16", 5)]


@pytest.mark.parametrize("kind,dtype,f", PACK_CASES)
def test_mask_compact_pack_plain_matches_jax_cases(kind, dtype, f):
    """Equal to the Pallas kernel bit for bit (rows are copied), f32 and
    bf16 rows, a bf16 row of odd F (the kernel's 2-byte chunks): the kept
    rows first-index-first, zeros from ``min(count, k)`` on."""
    rng = np.random.default_rng(len(kind) * 10 + f)
    mask, k = _pack_mask(kind, rng)
    pcT = rng.normal(size=(2, 3, N_PACK)).astype(np.float32)
    feat = rng.normal(size=(2, N_PACK, f)).astype(np.float32)
    want_f, want_p = pk.mask_compact_pack(
        jnp.asarray(mask), jnp.asarray(pcT), jnp.asarray(feat).astype(dtype),
        k, block=BLOCK, interpret=True)
    tfeat = _t(feat).to(getattr(torch, dtype))
    got_f, got_p = kernels.mask_compact_pack(_t(mask), _t(pcT), tfeat, k)
    assert got_f.shape == (2, k, f) and got_f.dtype == tfeat.dtype
    np.testing.assert_array_equal(got_f.float().numpy(),
                                  np.asarray(want_f.astype(jnp.float32)))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    for bb in range(2):
        kept = np.flatnonzero(mask[bb])[:k]
        assert torch.equal(got_f[bb, :len(kept)], tfeat[bb, kept])
        assert not got_f[bb, len(kept):].any()
        assert not got_p[bb, :, len(kept):].any()


# --------------------------------------------------------------------------
# the C interface: every CMR_EXPORT against _SIGNATURES / _RESTYPES
# --------------------------------------------------------------------------

_EXPORT = re.compile(r"CMR_EXPORT\s+([\w\s\*]+?)\s*(\bcmr_\w+)\s*\(([^)]*)\)",
                     re.S)


def _exports() -> dict:
    """``{name: (return type, [parameter declarations])}`` of every
    ``CMR_EXPORT`` function in ``csrc/*.cu``."""
    out = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        for ret, name, params in _EXPORT.findall(src.read_text()):
            params = [" ".join(p.split()) for p in params.split(",")
                      if p.strip() and p.strip() != "void"]
            out[name] = (" ".join(ret.split()), params)
    return out


def _ctype(decl: str, named: bool = True):
    """The ctypes type of a C parameter declaration (``named``: it ends in
    the parameter's name) or of a return type."""
    if "*" in decl:
        return ctypes.c_char_p if not named and "char" in decl else \
            ctypes.c_void_p
    words = decl.split()[:-1] if named else decl.split()
    kind = " ".join(w for w in words if w != "const")
    return {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}[kind]


EXPORTS = _exports()


def test_every_export_has_a_signature_and_none_is_stale():
    assert len(EXPORTS) >= 14
    assert set(EXPORTS) == set(kernels._SIGNATURES)
    assert set(kernels._RESTYPES) <= set(EXPORTS)


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_export_parameters_match_the_ctypes_signature(name):
    """One ctypes type per C parameter, in order: pointers (the stream
    too) ``c_void_p``, ``int`` ``c_int``, ``float`` ``c_float``; the return
    type ``c_int`` unless ``_RESTYPES`` names another, which must match."""
    ret, params = EXPORTS[name]
    assert kernels._SIGNATURES[name] == [_ctype(p) for p in params], params
    restype = kernels._RESTYPES.get(name, ctypes.c_int)
    assert restype is _ctype(ret, named=False), ret


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
