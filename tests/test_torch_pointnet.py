"""The port's PointNet++ modules against the JAX package's, on the CPU.

The shapes of ``tests/test_models.py::test_pointnet_capability_surface``
(an SA layer 128 -> 16 points, mlp (16, 32), and an FP layer back onto the
128 points) plus one MSG layer. The JAX variables are made by each JAX
module's ``init``, their BatchNorm statistics and affine moved off the
identity from a seed, and carried across by
``train.convert.flax_to_state_dict``. Coordinates lie on a 1/8 grid, so
the FPS, ball-query and 3-NN indices are exact in both packages and equal
in full order; the outputs are then held at atol 1e-5 (f32) in eval and
train mode, the running statistics after a train-mode call, and every
parameter's gradient at f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmr_agent_tpu.models import layers as jax_layers
from cmr_agent_tpu.models import pointnet as jpn
from cmr_agent_tpu_torch.models import pointnet as pn
from cmr_agent_tpu_torch.train.convert import flax_to_state_dict

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _F64Numpy:
    """``jax.numpy`` with ``float32`` standing for ``float64``: in place of
    the JAX layers module's ``jnp`` it makes the BatchNorm wrapper (which
    casts to f32) normalise in f64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _grid(rng, shape, span=1):
    return (rng.integers(-8 * span, 8 * span + 1, size=shape) / 8.0
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _moved(variables, seed):
    """The variables with BatchNorm scale/bias/mean/var off the identity."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if "BatchNorm_0" in name:
            if "'var'" in name or "'scale'" in name:
                return (a * rng.uniform(0.5, 1.5, a.shape)).astype(a.dtype)
            return (a + rng.normal(0.0, 0.2, a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(move, variables)


def _cases():
    """``(name, JAX module, port module, JAX args, port args)``."""
    rng = np.random.default_rng(3)
    xyz = _grid(rng, (2, 128, 3))
    feat = rng.normal(size=(2, 128, 4)).astype(np.float32)
    new_xyz = xyz[:, :16].copy()
    feat2 = rng.normal(size=(2, 16, 32)).astype(np.float32)
    return [
        ("sa", jpn.PointNetSetAbstraction(npoint=16, radius=0.5, nsample=8,
                                          mlp=(16, 32)),
         pn.PointNetSetAbstraction(16, 0.5, 8, 3, (16, 32)), (xyz, None)),
        ("sa_feat", jpn.PointNetSetAbstraction(npoint=16, radius=0.5,
                                               nsample=8, mlp=(16, 32)),
         pn.PointNetSetAbstraction(16, 0.5, 8, 7, (16, 32)), (xyz, feat)),
        ("sa_all", jpn.PointNetSetAbstraction(npoint=None, radius=None,
                                              nsample=None, mlp=(8,),
                                              group_all=True),
         pn.PointNetSetAbstraction(None, None, None, 7, (8,),
                                   group_all=True), (xyz, feat)),
        ("msg", jpn.PointNetSetAbstractionMsg(
            npoint=16, radius_list=(0.25, 0.5), nsample_list=(4, 8),
            mlp_list=((8, 16), (16,))),
         pn.PointNetSetAbstractionMsg(16, (0.25, 0.5), (4, 8), 4,
                                      ((8, 16), (16,))), (xyz, feat)),
        ("fp", jpn.PointNetFeaturePropagation(mlp=(16,)),
         pn.PointNetFeaturePropagation(32, (16,)),
         (xyz, new_xyz, None, feat2)),
        ("fp_feat", jpn.PointNetFeaturePropagation(mlp=(16, 8)),
         pn.PointNetFeaturePropagation(36, (16, 8)),
         (xyz, new_xyz, feat, feat2)),
    ]


CASES = {c[0]: c for c in _cases()}


def _jax_args(args, dtype=jnp.float32):
    return [None if a is None else jnp.asarray(a, dtype) for a in args]


def _port_args(args, dtype=torch.float32):
    return [None if a is None else _t(a).to(dtype) for a in args]


def _out(res):
    """The feature output (SA layers return ``(new_xyz, features)``)."""
    return res[1] if isinstance(res, tuple) else res


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name, jmod, mod, args = CASES[request.param]
    v = _moved(jmod.init(jax.random.key(0), *_jax_args(args)), seed=1)
    mod.load_state_dict(flax_to_state_dict(None, _np_tree(v), mod))
    return dict(name=name, jmod=jmod, mod=mod, args=args, v=v)


def test_eval_outputs_match_jax(case):
    want = case["jmod"].apply(case["v"], *_jax_args(case["args"]))
    with torch.no_grad():
        got = case["mod"].eval()(*_port_args(case["args"]))
    if isinstance(want, tuple):      # the SA layers' centres: exact
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(_out(got).numpy(), np.asarray(_out(want)),
                               rtol=0, atol=ATOL)


def test_train_mode_outputs_and_running_stats_match_jax(case):
    want, mutated = case["jmod"].apply(case["v"], *_jax_args(case["args"]),
                                       train=True, mutable=["batch_stats"])
    mod = case["mod"]
    saved = {k: v.clone() for k, v in mod.state_dict().items()}
    try:
        with torch.no_grad():
            got = mod.train()(*_port_args(case["args"]))
        np.testing.assert_allclose(_out(got).numpy(), np.asarray(_out(want)),
                                   rtol=0, atol=ATOL)
        want_sd = flax_to_state_dict(
            None, {"params": _np_tree(case["v"]["params"]),
                   "batch_stats": _np_tree(mutated["batch_stats"])}, mod)
        for k, buf in mod.named_buffers():
            np.testing.assert_allclose(buf.numpy(), want_sd[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    finally:
        mod.load_state_dict(saved)


def test_train_mode_gradients_match_jax_f64(case):
    """d(sum(out * ct))/d(params) in train mode at f64 in both packages,
    per tensor within 1e-6 of its max: the weight bridge rounds the JAX
    gradient to f32 (5.96e-8 relative), and f64 leaves the batch-statistics
    cancellation of an f32 gradient (1-3%) far below."""
    jmod, mod, v = case["jmod"], case["mod"], case["v"]
    rng = np.random.default_rng(2)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_layers, "jnp", _F64Numpy())
        f64 = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), t)
        jargs = _jax_args(case["args"], jnp.float64)
        shape = _out(jmod.apply(f64(v), *jargs, train=True,
                                mutable=["batch_stats"])[0]).shape
        ct = rng.normal(size=shape)

        def loss(p):
            res, _ = jmod.apply({"params": p,
                                 "batch_stats": f64(v["batch_stats"])},
                                *jargs, train=True, mutable=["batch_stats"])
            return jnp.sum(_out(res) * ct)
        grads = _np_tree(jax.jit(jax.grad(loss))(f64(v["params"])))
    want = flax_to_state_dict(None, {"params": grads,
                                     "batch_stats": _np_tree(
                                         v["batch_stats"])}, mod)
    saved = {k: t.clone() for k, t in mod.state_dict().items()}
    m64 = mod.double().train()
    try:
        m64.zero_grad()
        (_out(m64(*_port_args(case["args"], torch.float64)))
         * _t(ct)).sum().backward()
        for name, p in m64.named_parameters():
            w = want[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                       atol=1e-6 * np.abs(w).max() + 1e-12,
                                       err_msg=name)
    finally:
        mod.float().load_state_dict(saved)
        mod.zero_grad()


def test_sample_and_group_match_jax():
    rng = np.random.default_rng(4)
    xyz = _grid(rng, (2, 128, 3))
    feat = rng.normal(size=(2, 128, 4)).astype(np.float32)
    for points in (None, feat):
        want = jpn.sample_and_group(16, 0.5, 8, jnp.asarray(xyz),
                                    None if points is None
                                    else jnp.asarray(points))
        got = pn.sample_and_group(16, 0.5, 8, _t(xyz),
                                  None if points is None else _t(points))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        want = jpn.sample_and_group_all(jnp.asarray(xyz),
                                        None if points is None
                                        else jnp.asarray(points))
        got = pn.sample_and_group_all(_t(xyz),
                                      None if points is None else _t(points))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_the_gather_kernel_gate_is_jax_s():
    """Grouping from a table of at most 2048 rows read at least 2^20 times
    takes ``GatherRowsFn`` (the gather kernel on the card; its plain
    version here); below the gate a plain gather."""
    from cmr_agent_tpu_torch.ops import kernels
    calls = []
    apply = kernels.GatherRowsFn.apply
    rng = np.random.default_rng(5)
    xyz = _t(_grid(rng, (1, 1024, 3), span=4))
    feat = torch.randn(1, 1024, 8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels.GatherRowsFn, "apply",
                   lambda *a: (calls.append(a[0].shape), apply(*a))[1])
        pn.PointNetSetAbstraction(256, 0.5, 32, 11, (8,))(xyz, feat)
        # the grouped xyz and features (256 x 32 reads); the 256 centres
        # alone stay under the gate
        assert calls == [(1, 1024, 3), (1, 1024, 8)]
        calls.clear()
        pn.PointNetSetAbstraction(64, 0.5, 8, 11, (8,))(xyz, feat)
        assert calls == []
