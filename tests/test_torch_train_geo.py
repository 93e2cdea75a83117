"""The port's geo training path vs the JAX package on ``micro_config()``.

JAX references: the XLA fallbacks of every kernel on the CPU (the JAX
package never runs Pallas compiled there), the JAX train step's
``loss_fn`` (``train/train_geo.py:63-68``) for the loss terms, metrics and
BatchNorm stats, ``jax.grad`` of it at f64 compute for the gradients
against the port's at f64 compute (see the fixture), flax's ``BatchNorm``
through the JAX package's wrapper, and the JAX optax chain
(``train/optim.py``). Weights and gradients move through the weight
bridge (``flax_to_state_dict``; its transforms are linear, so a flax
gradient tree maps onto the port's ``.grad``s). Dropout is off on both
sides in the parity tests: flax's ``Dropout`` is patched to the identity
in this test process only, the port's rates are set to 0.
"""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from cmr_agent_tpu.config import Config as JaxConfig
from cmr_agent_tpu.config import micro_config as jax_micro_config
from cmr_agent_tpu.data import SyntheticDataset, collate
from cmr_agent_tpu.models import MultiHeadModel as JaxMultiHead
from cmr_agent_tpu.models import layers as jax_layers
from cmr_agent_tpu.models import point_encoder as jax_point_encoder
from cmr_agent_tpu.models.layers import BatchNorm as JaxBatchNorm
from cmr_agent_tpu.ops import losses as jax_losses
from cmr_agent_tpu.ops.pallas_kernels import segment_softmax_attend_fused
from cmr_agent_tpu.train.optim import make_lr_schedule as jax_schedule
from cmr_agent_tpu.train.optim import make_optimizer as jax_optimizer
from cmr_agent_tpu_torch.config import Config, micro_config
from cmr_agent_tpu_torch.models.layers import BatchNorm, Dropout, \
    set_dropout_rate
from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
from cmr_agent_tpu_torch.ops import losses
from cmr_agent_tpu_torch.train import train_geo
from cmr_agent_tpu_torch.train.convert import flax_to_state_dict
from cmr_agent_tpu_torch.train.optim import Optimizer, make_lr_schedule
from test_torch_train_kernels import (
    BF16_ULP, assert_scalar_within_jax_bf16_noise,
    assert_within_jax_bf16_noise)

LABEL_KEYS = ("img", "pc", "node", "pt2node", "K", "P", "pc_mask", "img_mask",
              "pc_idx_for_circle_loss", "pc_xy_float_for_circle_loss",
              "pc_xy_int_for_circle_loss")


class F64Numpy:
    """``jax.numpy`` with ``float32`` standing for ``float64``: put in
    place of the JAX layers module's ``jnp``, it makes the JAX BatchNorm
    wrapper (which casts to f32) normalise in f64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch_np(cfg, seed):
    ds = SyntheticDataset(cfg, length=2, seed=seed)
    b = collate([ds[0], ds[1]])
    return {k: b[k] for k in LABEL_KEYS}


@pytest.fixture(scope="module")
def step():
    """One train-mode forward + backward of both models from the same
    weights and batch (dropout off)."""
    jcfg, cfg = jax_micro_config(), micro_config()
    batch_np = _batch_np(jcfg, seed=4)
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    model = JaxMultiHead(jcfg)
    variables = model.init({"params": jax.random.key(0),
                            "dropout": jax.random.key(1)}, jb, train=False,
                           with_loss=True)
    rng = np.random.default_rng(5)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.2, a.shape).astype(
            np.float32), variables["batch_stats"])
    params = _numpy_tree(variables["params"])

    def loss_fn(p):
        out, mutated = model.apply(
            {"params": p, "batch_stats": stats}, jb, train=True,
            with_loss=True, rngs={"dropout": jax.random.key(2)},
            mutable=["batch_stats"])
        return out["loss"], (out, mutated["batch_stats"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, x, *a, **k: x)
        _, (jout, jstats) = loss_fn(params)
        # The gradient reference: the same JAX step at f64 compute (the
        # config's compute dtype patched to float64, and the BatchNorm
        # wrapper, which casts to f32, normalising in f64). In f32 a conv
        # or dense layer followed by batch-statistics BatchNorm has a
        # weight gradient made of heavily cancelling sums (flax's fast
        # variance E[x^2] - E[x]^2), and each package's f32 gradient of the
        # image branch's first convs is off the exact one by 1-3% of the
        # tensor's max, each in its own way: 100x the tolerance below.
        # Its loss terms, metrics and BatchNorm stats are the bf16 tests'
        # reference too.
        mp.setattr(JaxConfig, "jnp_dtype", lambda self: jnp.float64)
        mp.setattr(jax_layers, "jnp", F64Numpy())
        with jax.enable_x64(True):
            f64 = lambda t: jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64)
                if np.asarray(a).dtype == np.float32 else jnp.asarray(a), t)

            def loss64(p, st, b):
                out, mutated = model.apply(
                    {"params": p, "batch_stats": st}, b, train=True,
                    with_loss=True, mutable=["batch_stats"])
                return out["loss"], (out, mutated["batch_stats"])

            grads, (out64, stats64) = jax.jit(jax.grad(
                loss64, has_aux=True))(f64(params), f64(stats), f64(jb))
            ref64 = dict(
                grads=_numpy_tree(grads),
                out={k: float(out64[k]) for k in train_geo.METRIC_KEYS},
                stats=_numpy_tree(stats64))
            grads = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), grads)

    def port_model():
        m = MultiHeadModel(cfg)
        m.load_state_dict(flax_to_state_dict(
            cfg, {"params": params, "batch_stats": stats}, "multihead"))
        set_dropout_rate(m, 0.0)
        return m.train()

    tb = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    port = port_model()
    out = port(tb, with_loss=True)
    # the port's gradients at f64 compute too: its layers take their
    # compute dtype from the config when they are built, and its BatchNorm
    # keeps f64 inputs in f64
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Config, "torch_dtype", lambda self: torch.float64)
        port64 = port_model()
    port64(tb, with_loss=True)["loss"].backward()
    want_grads = flax_to_state_dict(
        cfg, {"params": _numpy_tree(grads), "batch_stats": stats},
        "multihead")
    want_stats = flax_to_state_dict(
        cfg, {"params": params, "batch_stats": _numpy_tree(jstats)},
        "multihead")
    return dict(port=port, port64=port64, out=out, jout=jout,
                want_grads=want_grads,
                want_stats=want_stats, params=params, stats=stats,
                batch_np=batch_np, ref64=ref64)


@pytest.mark.parametrize("key", train_geo.METRIC_KEYS)
def test_train_mode_loss_terms_and_metrics_match_jax(step, key):
    """Losses within rtol 1e-4; the P/R/A metrics count argmax decisions,
    so they may differ by a near-tie point or two (2e-3)."""
    got = step["out"][key].item()
    want = float(step["jout"][key])
    tol = 2e-3 if key.endswith(("precision", "recall", "accuracy")) \
        else 1e-4 * abs(want) + 1e-6
    assert abs(got - want) <= tol, (key, got, want)


def test_every_parameter_gradient_matches_jax(step):
    """Per tensor within 1e-4 max|g| + 1e-6 of the JAX step's gradient,
    both at f64 compute from the same f32 parameters."""
    checked = 0
    for name, p in step["port64"].named_parameters():
        want = step["want_grads"][name].numpy()
        got = p.grad.numpy()
        tol = 1e-4 * np.abs(want).max() + 1e-6
        assert np.abs(got - want).max() <= tol, name
        checked += 1
    assert checked == len(list(step["port64"].parameters()))


def test_batchnorm_stats_after_the_step_match_jax(step):
    for name, buf in step["port"].named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(),
                                       step["want_stats"][name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def _state_dict(cfg, params, stats):
    f32 = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), t)
    return flax_to_state_dict(cfg, {"params": f32(params),
                                    "batch_stats": f32(stats)}, "multihead")


@pytest.fixture(scope="module")
def bf16_step(step):
    """The same step with ``compute_dtype="bfloat16"`` in both packages
    (parameters and BatchNorm stats f32, activations bf16), from the
    weights and batch of :func:`step`: the JAX side with its segment
    softmax through the Pallas kernel in interpret mode (its TPU route,
    as ``tests/test_torch_checkpoint.py`` runs it), jitted; its f64
    reference is :func:`step`'s (the XLA segment softmax: exact at f64
    either way)."""
    jcfg, cfg = (jax_micro_config(compute_dtype="bfloat16"),
                 micro_config(compute_dtype="bfloat16"))
    params, stats = step["params"], step["stats"]
    jb = {k: jnp.asarray(v) for k, v in step["batch_np"].items()}
    model = JaxMultiHead(jcfg)

    def fused(attn, values, idx, m, use_pallas=None):
        return segment_softmax_attend_fused(
            attn, values, idx.astype(jnp.int32), m, interpret=True)

    def loss_fn(p, b):
        out, mutated = model.apply(
            {"params": p, "batch_stats": stats}, b, train=True,
            with_loss=True, mutable=["batch_stats"])
        return out["loss"], (out, mutated["batch_stats"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        mp.setattr(jax_point_encoder, "batched_segment_softmax_attend",
                   fused)
        grads, (jout, jstats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
            params, jb)
    port = MultiHeadModel(cfg)
    port.load_state_dict(_state_dict(cfg, params, stats))
    set_dropout_rate(port, 0.0)
    port.train()
    dtypes = set()
    hooks = [m.register_forward_hook(
        lambda mod, i, o: dtypes.add(o.dtype)) for m in port.modules()
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d))]
    out = port({k: torch.from_numpy(v) for k, v in step["batch_np"].items()},
               with_loss=True)
    for h in hooks:
        h.remove()
    out["loss"].backward()
    ref = step["ref64"]
    return dict(port=port, out=out, jout=jout, dtypes=dtypes,
                grads=_state_dict(cfg, grads, stats),
                stats=_state_dict(cfg, params, jstats),
                ref_grads=_state_dict(cfg, ref["grads"], stats),
                ref_out=ref["out"],
                ref_stats=_state_dict(cfg, params, ref["stats"]))


@pytest.mark.parametrize("key", train_geo.METRIC_KEYS)
def test_bf16_loss_terms_and_metrics_match_jax(bf16_step, key):
    """The gate of ``assert_scalar_within_jax_bf16_noise``: losses with a
    floor of one bf16 rounding of the reference; the P/R/A shares count
    argmax decisions, and a near tie may fall either way in bf16, so their
    floor is two decisions of the smallest count here (the image recall's
    230 positives; one flipped there in the port, none in JAX's step)."""
    got = bf16_step["out"][key]
    assert got.dtype == torch.float32, key
    ref = bf16_step["ref_out"][key]
    floor = 2 / 230 if key.endswith(("precision", "recall", "accuracy")) \
        else BF16_ULP * abs(ref)
    assert_scalar_within_jax_bf16_noise(got.item(),
                                        float(bf16_step["jout"][key]), ref,
                                        floor)


def test_bf16_parameter_gradients_and_stats_match_jax(bf16_step,
                                                      record_property):
    """Every parameter gradient and running statistic under the bf16 gate
    (``test_torch_train_kernels.py``); parameters, gradients and running
    stats stay f32, every dense and conv layer computed in bf16."""
    port = bf16_step["port"]
    assert bf16_step["dtypes"] == {torch.bfloat16}
    grads = {}
    for name, p in port.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        grads[name] = (p.grad.numpy(), bf16_step["grads"][name].numpy(),
                       bf16_step["ref_grads"][name].numpy())
    assert len(grads) == len(bf16_step["grads"]) - sum(
        k.endswith(("running_mean", "running_var"))
        for k in bf16_step["grads"])
    record_property("gradients", assert_within_jax_bf16_noise(grads))
    stats = {}
    for name, buf in port.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert buf.dtype == torch.float32, name
            stats[name] = (buf.numpy(), bf16_step["stats"][name].numpy(),
                           bf16_step["ref_stats"][name].numpy())
    record_property("running_stats",
                    assert_within_jax_bf16_noise(stats, gradients=False))


@pytest.mark.parametrize("shape,dim", [((3, 40, 6), -1), ((2, 6, 5, 7), 1)])
def test_batchnorm_train_mode_matches_flax(shape, dim):
    """Batch-statistics output (biased variance) and the momentum-0.9
    running-stat update; the port's NCHW BatchNorm (dim=1) against the
    JAX NHWC one."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=shape) * 2 + 1.5).astype(np.float32)
    x_nhwc = np.moveaxis(x, 1, -1) if dim == 1 else x
    c = shape[dim]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    mean0 = rng.normal(size=c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean0,
                                                 "var": var0}}}
    want, mutated = JaxBatchNorm().apply(variables, jnp.asarray(x_nhwc),
                                         True, mutable=["batch_stats"])
    want = np.asarray(want)
    if dim == 1:
        want = np.moveaxis(want, -1, 1)
    bn = BatchNorm(c, dim=dim).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
        got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    new = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), new["mean"],
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), new["var"], atol=1e-5)


def test_dropout_keep_rate_scaling_and_seed():
    """Keep rate 1 - p within 3 sigma, kept values scaled by 1/(1-p),
    identical masks from identical seeds, identity in eval mode."""
    p, n = 0.25, 200_000
    drop = Dropout(p).train()
    x = torch.ones(n)
    drop.generator = torch.Generator().manual_seed(3)
    y1 = drop(x)
    drop.generator = torch.Generator().manual_seed(3)
    y2 = drop(x)
    kept = y1 != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 3 * np.sqrt(
        p * (1 - p) / n)
    torch.testing.assert_close(y1[kept], torch.full_like(y1[kept],
                                                         1 / (1 - p)))
    assert torch.equal(y1, y2)
    assert torch.equal(drop.eval()(x), x)


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(2, 50, 3)) * 2).astype(np.float32)
    labels = rng.integers(0, 3, size=(2, 50)).astype(np.int32)
    img = rng.normal(size=(2, 12, 8)).astype(np.float32)
    pc = (img + rng.normal(size=img.shape) * 0.3).astype(np.float32)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    pc /= np.linalg.norm(pc, axis=-1, keepdims=True)
    dmap = rng.uniform(0.0, 3.0, size=(2, 12, 12)).astype(np.float32)
    return logits, labels, img, pc, dmap


@pytest.mark.parametrize("which", ["cross_entropy", "focal", "circle"])
def test_losses_and_gradients_match_jax(which):
    logits, labels, img, pc, dmap = _loss_inputs(8)
    if which == "circle":
        jfn = lambda a, b: jax_losses.circle_loss(a, b, jnp.asarray(dmap))[0]
        tfn = lambda a, b: losses.circle_loss(a, b, torch.from_numpy(dmap))[0]
        args = (img, pc)
    else:
        jf, tf = {"cross_entropy": (jax_losses.softmax_cross_entropy,
                                    losses.softmax_cross_entropy),
                  "focal": (lambda x, y: jax_losses.focal_loss(x, y, 0.75),
                            lambda x, y: losses.focal_loss(x, y, 0.75))}[which]
        jfn = lambda a: jf(a, jnp.asarray(labels))
        tfn = lambda a: tf(a, torch.from_numpy(labels))
        args = (logits,)
    want, want_g = jax.value_and_grad(jfn, argnums=tuple(
        range(len(args))))(*(jnp.asarray(a) for a in args))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = tfn(*targs)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want)) + 1e-6
    for t, g in zip(targs, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5)


@pytest.mark.parametrize("opt", ["ADAM", "SGD"])
def test_optimizer_matches_optax_across_a_steplr_boundary(opt):
    """The same numpy gradients for 5 steps into both chains (clip 1.0,
    coupled L2, Adam/SGD, StepLR with the boundary after step 2):
    parameters within 1e-6."""
    kw = dict(optimizer=opt, step_size=2, weight_decay=1e-2, lr=1e-2)
    jcfg, cfg = jax_micro_config(**kw), micro_config(**kw)
    rng = np.random.default_rng(9)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 1.5).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    tx = jax_optimizer(jcfg, steps_per_epoch=1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    import optax
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt_ = Optimizer(cfg, tp.values(), steps_per_epoch=1)
    for g in grads:
        opt_.zero_grad()
        for k, v in g.items():
            tp[k].grad = torch.from_numpy(v.copy())
        opt_.step()
    assert opt_.count == 5
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6)


@pytest.mark.parametrize("sched", ["StepLR", "ExponentialLR",
                                   "CosineAnnealingLR"])
def test_lr_schedules_match_jax(sched):
    jcfg = jax_micro_config(lr_scheduler=sched)
    cfg = micro_config(lr_scheduler=sched)
    want, got = jax_schedule(jcfg, 7), make_lr_schedule(cfg, 7)
    for s in (0, 6, 7, 27, 28, 69, 70, 500):
        assert abs(got(s) - float(want(s))) <= 1e-6 * cfg.lr, (s, sched)


def test_geo_train_step_descends():
    """The JAX package's tests/test_train.py:33 on the port: four steps on
    one batch lower the loss; the eval step stays finite."""
    cfg = micro_config()
    batch_np = _batch_np(cfg, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    state = train_geo.create_geo_state(cfg, device="cpu", seed=0)
    step_fn = train_geo.make_geo_train_step(cfg)
    gen = torch.Generator().manual_seed(1)
    losses_ = [step_fn(state, batch, gen)["loss"].item() for _ in range(4)]
    assert np.isfinite(losses_).all()
    assert losses_[-1] < losses_[0]
    assert state.step == 4
    metrics = train_geo.make_geo_eval_step(cfg)(state, batch)
    assert np.isfinite(metrics["loss"].item())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
