"""The port's remaining sampling, segment and geometry ops and the Lovasz
losses against the JAX package's, on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
Where an op returns indices, the coordinates lie on a 1/8 grid: every
squared distance is then exact in f32 in both packages (the matmul
expansion included), so ties and points exactly on the radius fall the
same way, and the indices must be equal in full order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from cmr_agent_tpu.ops import geometry as jgeo
from cmr_agent_tpu.ops import losses as jlosses
from cmr_agent_tpu.ops import sampling as jsampling
from cmr_agent_tpu.ops import scatter as jscatter
from cmr_agent_tpu_torch.ops import geometry, losses, sampling, scatter


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid(rng, shape, span=8):
    """Coordinates on a 1/8 grid in ``[-span, span]``."""
    return (rng.integers(-8 * span, 8 * span + 1, size=shape) / 8.0
            ).astype(np.float32)


# ---------------------------------------------------------------- geometry

def test_euler_xyz_extrinsic_matches_jax_and_scipy():
    """Rz Ry Rx: equal to JAX's to the last bit but one (the two packages'
    sin/cos may round apart by an ulp), and to scipy's ``from_euler('xyz')``
    within 1e-6; ``angle2matrix_sxyz`` is the same function."""
    rng = np.random.default_rng(0)
    e = rng.uniform(-np.pi, np.pi, size=(64, 3)).astype(np.float32)
    got = geometry.euler_xyz_extrinsic_to_matrix(_t(e)).numpy()
    want = np.asarray(jgeo.euler_xyz_extrinsic_to_matrix(jnp.asarray(e)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(
        got, Rotation.from_euler("xyz", e.astype(np.float64)).as_matrix(),
        rtol=0, atol=1e-6)
    assert geometry.angle2matrix_sxyz is geometry.euler_xyz_extrinsic_to_matrix
    # exact where sin and cos are: quarter turns
    q = (rng.integers(-2, 3, size=(16, 3)) * (np.pi / 2)).astype(np.float32)
    np.testing.assert_array_equal(
        geometry.euler_xyz_extrinsic_to_matrix(_t(q)).numpy(),
        np.asarray(jgeo.euler_xyz_extrinsic_to_matrix(jnp.asarray(q))))


# ---------------------------------------------------------------- segments

def _segment_inputs(seed, n=300, f=5, m=17, dtype=np.float32):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, f)).astype(dtype)
    ids = rng.integers(0, m, size=n).astype(np.int32)
    ids[ids == 3] = 4              # segment 3 empty
    ids[-1] = m - 2                # the last segment empty too
    ids[ids == m - 1] = m - 2
    return data, ids


@pytest.mark.parametrize("via", ["scatter", "matmul", "auto"])
@pytest.mark.parametrize("n", [300, 5000])
def test_segment_sum_matches_jax(via, n):
    data, ids = _segment_inputs(1, n=n)
    got = scatter.segment_sum(_t(data), _t(ids), 17, via=via).numpy()
    want = np.asarray(jscatter.segment_sum(jnp.asarray(data),
                                           jnp.asarray(ids), 17, via=via))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert (got[3] == 0).all() and (got[16] == 0).all()


def test_segment_sum_matmul_equals_scatter():
    """The one-hot matmul route gives the scatter's sums: the same bits on
    values whose every partial sum is exact (a 1/8 grid), and on normal
    values within rtol 1e-6 of the segment's sum of magnitudes (the two
    routes add in different orders, and ~350 rows of a segment cancel)."""
    rng = np.random.default_rng(2)
    _, ids = _segment_inputs(2, n=6000)
    exact = _grid(rng, (6000, 5))
    for data in (exact, rng.normal(size=(6000, 5)).astype(np.float32)):
        mm = scatter.segment_sum(_t(data), _t(ids), 17, via="matmul").numpy()
        sc = scatter.segment_sum(_t(data), _t(ids), 17,
                                 via="scatter").numpy()
        mags = scatter.segment_sum(_t(np.abs(data)), _t(ids), 17,
                                   via="scatter").numpy()
        assert (np.abs(mm - sc) <= 1e-6 * mags).all()
        if data is exact:
            np.testing.assert_array_equal(mm, sc)


def test_segment_ops_drop_out_of_range_ids():
    """Ids below 0 or at and above ``num_segments`` are dropped, as
    ``jax.ops.segment_*`` drop them, in every op and route."""
    data, ids = _segment_inputs(3, n=200)
    ids[:7] = 17
    ids[7:12] = -1
    ids[12:15] = 40
    for fn, args in ((scatter.segment_sum, ("scatter",)),
                     (scatter.segment_sum, ("matmul",)),
                     (scatter.segment_mean, ("scatter",)),
                     (scatter.segment_max, ())):
        jfn = getattr(jscatter, fn.__name__)
        got = fn(_t(data), _t(ids), 17, *args).numpy()
        want = np.asarray(jfn(jnp.asarray(data), jnp.asarray(ids), 17,
                              *args))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=f"{fn.__name__}{args}")


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_max_fills_empty_segments_as_jax(dtype):
    """An empty segment's max is what ``jax.ops.segment_max`` gives: -inf
    for floats (not the dtype's finite minimum), the minimum for ints."""
    data, ids = _segment_inputs(4)
    if dtype == np.int32:
        data = (data * 100).astype(np.int32)
    got = scatter.segment_max(_t(data), _t(ids), 17).numpy()
    want = np.asarray(jscatter.segment_max(jnp.asarray(data),
                                           jnp.asarray(ids), 17))
    np.testing.assert_array_equal(got, want)
    fill = -np.inf if dtype == np.float32 else np.iinfo(np.int32).min
    assert (got[3] == fill).all() and (got[16] == fill).all()


@pytest.mark.parametrize("shape", [(300,), (300, 5)])
def test_segment_mean_matches_jax_and_is_zero_when_empty(shape):
    data, ids = _segment_inputs(5)
    data = data[:, 0] if len(shape) == 1 else data
    got = scatter.segment_mean(_t(data), _t(ids), 17).numpy()
    want = np.asarray(jscatter.segment_mean(jnp.asarray(data),
                                            jnp.asarray(ids), 17))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[3] == 0).all() and (got[16] == 0).all()


def test_segment_softmax_attend_matches_jax():
    """The unbatched group softmax: each segment shifted by its own max
    (the JAX package's XLA route), empty segments 0, routed-out rows
    dropped; logits spread wide enough that a shared shift would
    underflow whole segments."""
    rng = np.random.default_rng(6)
    attn = (rng.normal(size=(400, 6)) * 30).astype(np.float32)
    values = rng.normal(size=(400, 6)).astype(np.float32)
    ids = rng.integers(0, 23, size=400).astype(np.int32)
    ids[ids == 5] = 6
    attn[ids == 7] -= 200.0
    ids[:9] = 23                                   # routed out
    got = scatter.segment_softmax_attend(_t(attn), _t(values), _t(ids),
                                         23).numpy()
    want = np.asarray(jscatter.segment_softmax_attend(
        jnp.asarray(attn), jnp.asarray(values), jnp.asarray(ids), 23))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (got[5] == 0).all() and np.abs(got[7]).max() > 0


@pytest.mark.parametrize("name", ["batched_segment_sum",
                                  "batched_segment_max",
                                  "batched_segment_mean"])
def test_batched_segment_ops_match_jax(name):
    """The JAX package's ``vmap`` forms; at N = 4096 the sums and means
    take the one-hot matmul route in both packages ("auto")."""
    rng = np.random.default_rng(7)
    data = rng.normal(size=(3, 4096, 4)).astype(np.float32)
    ids = rng.integers(0, 50, size=(3, 4096)).astype(np.int32)
    ids[1, ids[1] == 9] = 10
    args = (50,) if name == "batched_segment_max" else (50, "auto")
    got = getattr(scatter, name)(_t(data), _t(ids), *args).numpy()
    want = np.asarray(getattr(jscatter, name)(jnp.asarray(data),
                                              jnp.asarray(ids), *args))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------- sampling

def test_nearest_assign_matches_jax_on_grid_coordinates():
    """First minimum of the matmul-expanded distances; the grid makes
    many centres equidistant, and both packages take the first."""
    rng = np.random.default_rng(8)
    pts = _grid(rng, (2, 500, 3), span=2)
    ctr = _grid(rng, (2, 40, 3), span=2)
    ctr[:, 1] = ctr[:, 0]                          # a duplicated centre
    got = sampling.nearest_assign(_t(pts), _t(ctr))
    want = np.asarray(jsampling.nearest_assign(jnp.asarray(pts),
                                               jnp.asarray(ctr)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not (got.numpy() == 1).any()            # the first copy wins


@pytest.mark.parametrize("init", [None, 7, "per_sample"])
def test_farthest_point_sample_matches_jax(init):
    """Full order equal to JAX's ``_fps_single`` on grid coordinates,
    whose ties are many: both take the first farthest point."""
    rng = np.random.default_rng(9)
    pts = _grid(rng, (3, 400, 3), span=1)
    init_idx = (np.array([5, 0, 399], np.int32) if init == "per_sample"
                else init)
    got = sampling.farthest_point_sample(_t(pts), 64, init_idx=init_idx)
    want = np.asarray(jsampling.farthest_point_sample(
        jnp.asarray(pts), 64, init_idx=init_idx))
    assert got.dtype == torch.int32 and got.shape == (3, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    one = sampling.farthest_point_sample(_t(pts[1]), 64, init_idx=init_idx
                                         if init != "per_sample" else 0)
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jsampling.farthest_point_sample(
            jnp.asarray(pts[1]), 64, init_idx=init_idx
            if init != "per_sample" else 0)))


def test_farthest_point_sample_draws_its_start_from_the_generator():
    rng = np.random.default_rng(10)
    pts = _t(_grid(rng, (2, 300, 3)))
    a = sampling.farthest_point_sample(pts, 16,
                                       torch.Generator().manual_seed(3))
    b = sampling.farthest_point_sample(pts, 16,
                                       torch.Generator().manual_seed(3))
    start = torch.randint(0, 300, (2,),
                          generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and torch.equal(a[:, 0], start.to(torch.int32))
    np.testing.assert_array_equal(
        a.numpy(), np.asarray(jsampling.farthest_point_sample(
            jnp.asarray(pts.numpy()), 16, init_idx=start.numpy())))


@pytest.mark.parametrize("radius,nsample", [(0.5, 8), (1.0, 32), (0.25, 4)])
def test_query_ball_point_matches_jax_on_grid_coordinates(radius, nsample):
    """Equal in full order to JAX's, points exactly on the radius inside
    (the grid puts many there), short groups padded with their first
    index."""
    rng = np.random.default_rng(11)
    xyz = _grid(rng, (2, 256, 3), span=1)
    centres = xyz[:, ::16].copy()
    got = sampling.query_ball_point(radius, nsample, _t(xyz), _t(centres))
    want = np.asarray(jsampling.query_ball_point(
        radius, nsample, jnp.asarray(xyz), jnp.asarray(centres)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    d = ((xyz[:, None, :, :] - centres[:, :, None, :]) ** 2).sum(-1)
    assert (d == np.float32(radius) ** 2).any()    # on the boundary


@pytest.mark.parametrize("n_in,n_out", [(100, 30), (100, 100), (30, 100),
                                        (7, 64)])
def test_random_downsample_indices_policy(n_in, n_out):
    """The policy of JAX's ``random_downsample_indices`` (its draws come
    from ``jax.random``, so its bits cannot be matched): a permutation's
    prefix when there are enough points; else whole-cloud tiles, then
    distinct extras."""
    got = sampling.random_downsample_indices(
        torch.Generator().manual_seed(0), n_in, n_out).numpy()
    want = np.asarray(jsampling.random_downsample_indices(
        jax.random.key(0), n_in, n_out))
    assert got.shape == want.shape == (n_out,)
    reps = n_out // n_in
    if n_in >= n_out:
        for idx in (got, want):
            assert len(set(idx.tolist())) == n_out and idx.max() < n_in
    else:
        for idx in (got, want):
            np.testing.assert_array_equal(idx[:reps * n_in],
                                          np.tile(np.arange(n_in), reps))
            extra = idx[reps * n_in:]
            assert len(set(extra.tolist())) == len(extra) == n_out % n_in
    again = sampling.random_downsample_indices(
        torch.Generator().manual_seed(0), n_in, n_out).numpy()
    np.testing.assert_array_equal(got, again)


# ------------------------------------------------------------------ Lovasz

def _lovasz_inputs(seed, ties):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=60)
    labels = rng.integers(0, 2, size=60).astype(np.float64)
    probs = rng.dirichlet(np.ones(4), size=60)
    cls = rng.integers(0, 3, size=60)              # class 3 absent
    if ties:
        logits[10:20] = 0.25                       # tied errors
        probs[5:15] = 0.25
    return logits, labels, probs, cls


@pytest.mark.parametrize("ties", [False, True])
def test_lovasz_hinge_value_and_gradient_match_jax_f64(ties):
    logits, labels, _, _ = _lovasz_inputs(12, ties)
    with jax.enable_x64(True):
        want, wgrad = jax.value_and_grad(jlosses.lovasz_hinge)(
            jnp.asarray(logits), jnp.asarray(labels))
        want, wgrad = float(want), np.asarray(wgrad)
    x = _t(logits).requires_grad_(True)
    got = losses.lovasz_hinge(x, _t(labels))
    got.backward()
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.item(), want, rtol=1e-12)
    np.testing.assert_allclose(x.grad.numpy(), wgrad, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("ties", [False, True])
def test_lovasz_softmax_value_and_gradient_match_jax_f64(ties):
    """Classes absent from the labels carry no weight (class 3 here)."""
    _, _, probs, cls = _lovasz_inputs(13, ties)
    with jax.enable_x64(True):
        want, wgrad = jax.value_and_grad(jlosses.lovasz_softmax)(
            jnp.asarray(probs), jnp.asarray(cls))
        want, wgrad = float(want), np.asarray(wgrad)
    p = _t(probs).requires_grad_(True)
    got = losses.lovasz_softmax(p, _t(cls))
    got.backward()
    np.testing.assert_allclose(got.item(), want, rtol=1e-12)
    np.testing.assert_allclose(p.grad.numpy(), wgrad, rtol=1e-12, atol=1e-15)
    assert (p.grad.numpy()[:, 3] == 0).all()
