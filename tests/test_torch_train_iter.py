"""The port's IterModel training (``train/train_iter.py``), its remat, its
train checkpoint, and the geo multi-step (``train/train_geo.py``) vs the
JAX package, on the CPU in f32.

JAX references: ``make_iter_train_step`` with the JAX ``IterModel``'s
default CPU path (the chunked scatter over every masked point; the port's
compaction drops nothing at 256 points), ``per_axis_accuracy``, and
``make_geo_multi_step`` with flax's ``Dropout`` patched to the identity in
this test process only (the port's dropout rates set to 0). Weights go
through the bridge (``flax_to_state_dict``).
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from cmr_agent_tpu.config import Config as JaxConfig
from cmr_agent_tpu.config import micro_config as jax_micro_config
from cmr_agent_tpu.config import tiny_config as jax_tiny_config
from cmr_agent_tpu.data import SyntheticDataset, collate
from cmr_agent_tpu.models import IterModel as JaxIterModel
from cmr_agent_tpu.models import MultiHeadModel as JaxMultiHead
from cmr_agent_tpu.models import cost_volume as jax_cost_volume
from cmr_agent_tpu.models import layers as jax_layers
from cmr_agent_tpu.train import train_geo as jax_train_geo
from cmr_agent_tpu.train import train_iter as jax_train_iter
from cmr_agent_tpu.train.optim import make_optimizer as jax_optimizer
from cmr_agent_tpu_torch.config import micro_config, tiny_config
from cmr_agent_tpu_torch.models.cost_volume import IterModel
from cmr_agent_tpu_torch.models.layers import BatchNorm, set_dropout_rate
from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
from cmr_agent_tpu_torch.train import checkpoint, train_geo, train_iter
from cmr_agent_tpu_torch.train.convert import flax_to_state_dict
from cmr_agent_tpu_torch.train.optim import Optimizer
from test_torch_train_agent import _capture_grads
from test_torch_train_geo import F64Numpy
from test_torch_train_kernels import (
    BF16_ULP, assert_scalar_within_jax_bf16_noise,
    assert_within_jax_bf16_noise)

# tiny width, 256 points, nlabel 3 (27 hypotheses), batch 2
OVER = dict(num_pt=256, cropped_img_h=64, cropped_img_w=128, nlabel=3,
            cost_volume_eval_chunk=9)
LR = 1e-3


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state(cfg, seed, b=2):
    """A seeded IterModel input state with decode labels: a cloud in front
    of the camera, random features, half the points predicted overlap."""
    rng = np.random.default_rng(seed)
    n, h, w, f = cfg.num_pt, cfg.image_h, cfg.image_w, cfg.embed_dim
    K = np.array([[float(w), 0, w / 2], [0, float(w), h / 2], [0, 0, 1]],
                 np.float32)
    overlap = rng.integers(0, 2, size=(b, n)).astype(bool)
    state = {
        "pc_i": (rng.normal(size=(b, n, 3)) + [0, 0, 4]).astype(np.float32),
        "K": np.broadcast_to(K, (b, 3, 3)).copy(),
        "pc_geo_feat": rng.normal(size=(b, n, f)).astype(np.float32),
        "img_geo_feat": rng.normal(size=(b, h, w, f)).astype(np.float32),
        "pc_overlap_pred": overlap,
        "pc_overlap_pred_standby": overlap & (rng.uniform(size=(b, n)) > .5),
        "pc_is_in_cam_scores": rng.uniform(size=(b, n)).astype(np.float32),
        "img_overlap_pred": rng.uniform(size=(b, h, w)).astype(np.float32),
        "matrix_accumulated": np.broadcast_to(
            np.eye(4, dtype=np.float32), (b, 4, 4)).copy(),
        "R_amplitude": np.full((b,), np.pi, np.float32),
        "T_amplitude": np.full((b,), 5.0, np.float32),
    }
    for key in ("label_R", "label_T_x", "label_T_z"):
        lab = np.zeros((b, cfg.nlabel), np.float32)
        lab[np.arange(b), rng.integers(0, cfg.nlabel, size=b)] = 1.0
        state[key] = lab
    return state


def _torch(state_np):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in state_np.items()}


def _port_state(cfg, ivars):
    model = IterModel(cfg)
    model.load_state_dict(flax_to_state_dict(cfg, ivars, "itermodel"))
    return train_iter.IterTrainState(
        model, Optimizer(cfg, model.parameters(), steps_per_epoch=1000))


@pytest.fixture(scope="module")
def iter_step():
    """One train step of both packages from the same weights and state.
    The fresh init scores every hypothesis alike to seven digits, so the
    kernels are widened and the biases and running stats given values, as
    tests/test_torch_cost_volume.py does."""
    jcfg, cfg = jax_tiny_config(lr=LR, **OVER), tiny_config(lr=LR, **OVER)
    state = _state(jcfg, 7)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    ivars = _numpy_tree(JaxIterModel(jcfg).init(
        {"params": jax.random.key(3)}, jstate, train=False, with_loss=False))
    rng = np.random.default_rng(8)

    def widen(path, a):
        name = path[-1].key
        if name == "kernel":
            return (3.0 * a).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.2 * rng.normal(size=a.shape)).astype(np.float32)
        return (a + 0.3 * rng.uniform(size=a.shape)).astype(np.float32)

    ivars = jax.tree_util.tree_map_with_path(widen, ivars)
    tx = jax_optimizer(jcfg, 1000)
    jts = jax_train_iter.IterTrainState(
        step=jnp.zeros((), jnp.int32), params=ivars["params"],
        batch_stats=ivars["batch_stats"], opt_state=tx.init(ivars["params"]),
        tx=tx, apply_fn=JaxIterModel(jcfg).apply)
    jts, jmetrics = jax_train_iter.make_iter_train_step(jcfg)(jts, jstate)
    # the JAX gradient, for which elements the Adam step's sign is sure
    grads = jax.grad(lambda p: JaxIterModel(jcfg).apply(
        {"params": p, "batch_stats": ivars["batch_stats"]}, jstate,
        train=True, with_loss=True, mutable=["batch_stats"]
    )[0]["cost_volume_loss"])(ivars["params"])
    port = _port_state(cfg, ivars)
    metrics = train_iter.make_iter_train_step(cfg)(port, _torch(state))
    after = flax_to_state_dict(cfg, {"params": _numpy_tree(jts.params),
                                     "batch_stats": _numpy_tree(
                                         jts.batch_stats)}, "itermodel")
    want_grads = flax_to_state_dict(
        cfg, {"params": _numpy_tree(grads),
              "batch_stats": ivars["batch_stats"]}, "itermodel")
    return dict(cfg=cfg, state=state, ivars=ivars, port=port,
                metrics=metrics, jmetrics=jmetrics, after=after,
                want_grads=want_grads)


def _jax_iter_grads(jcfg, params, stats, state):
    """The JAX IterModel train step's gradients (an optax transform that
    hands them back), metrics and running stats."""
    cap = _capture_grads()
    jts = jax_train_iter.IterTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=cap.init(params), tx=cap, apply_fn=JaxIterModel(jcfg).apply)
    jts, metrics = jax_train_iter.make_iter_train_step(jcfg)(jts, state)
    return (_numpy_tree(jts.opt_state),
            {k: float(v) for k, v in metrics.items()},
            _numpy_tree(jts.batch_stats))


@pytest.fixture(scope="module")
def bf16_iter_step(iter_step):
    """The step with ``compute_dtype="bfloat16"`` in both packages on
    :func:`iter_step`'s weights and state, the JAX step at f64 compute as
    the reference (the config's dtype, the BatchNorm and the cost-volume
    module's f32 casts patched to f64), and the port's step with and
    without remat."""
    kw = dict(lr=LR, compute_dtype="bfloat16", **OVER)
    jcfg, cfg = jax_tiny_config(**kw), tiny_config(**kw)
    ivars, state = iter_step["ivars"], iter_step["state"]
    want = _jax_iter_grads(jcfg, ivars["params"], ivars["batch_stats"],
                           {k: jnp.asarray(v) for k, v in state.items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxConfig, "jnp_dtype", lambda self: jnp.float64)
        mp.setattr(jax_layers, "jnp", F64Numpy())
        mp.setattr(jax_cost_volume, "jnp", F64Numpy())
        with jax.enable_x64(True):
            f64 = lambda t: jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64)
                if np.asarray(a).dtype == np.float32 else jnp.asarray(a), t)
            ref = _jax_iter_grads(jax_tiny_config(lr=LR, **OVER),
                                  f64(ivars["params"]),
                                  f64(ivars["batch_stats"]), f64(state))

    def sd(p, st):
        f32 = lambda t: jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), t)
        return flax_to_state_dict(cfg, {"params": f32(p),
                                        "batch_stats": f32(st)}, "itermodel")
    out = dict(want_metrics=want[1], ref_metrics=ref[1],
               want_grads=sd(want[0], ivars["batch_stats"]),
               ref_grads=sd(ref[0], ivars["batch_stats"]),
               want_stats=sd(ivars["params"], want[2]),
               ref_stats=sd(ivars["params"], ref[2]))
    for remat in (False, True):
        c = dataclasses.replace(cfg, cost_volume_remat=remat)
        port = _port_state(c, ivars)
        grads, step = {}, port.optimizer.step

        def record_and_step():
            grads.update({n: p.grad.detach().clone()
                          for n, p in port.model.named_parameters()})
            step()
        port.optimizer.step = record_and_step
        dtypes = set()
        hooks = [m.register_forward_hook(
            lambda mod, i, o: dtypes.add(o.dtype))
            for m in port.model.modules() if isinstance(m, torch.nn.Conv2d)]
        metrics = train_iter.make_iter_train_step(c)(port, _torch(state))
        for h in hooks:
            h.remove()
        out[remat] = dict(port=port, grads=grads, metrics=metrics,
                          dtypes=dtypes)
    return out


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("key", train_iter.METRIC_KEYS)
def test_bf16_iter_step_metrics_match_jax(bf16_iter_step, key, remat):
    """The loss f32, under ``assert_scalar_within_jax_bf16_noise`` with a
    floor of one bf16 rounding of the reference; the accuracies are
    shares of the batch's 2 argmax decisions, and a near tie may fall
    either way in bf16 (acc_tz did, in the port's step): floor one
    decision, 1/2."""
    got = bf16_iter_step[remat]["metrics"][key]
    assert got.dtype == torch.float32, key
    ref = bf16_iter_step["ref_metrics"][key]
    floor = BF16_ULP * abs(ref) if key == "cost_volume_loss" else 0.5
    assert_scalar_within_jax_bf16_noise(
        got.item(), bf16_iter_step["want_metrics"][key], ref, floor)


@pytest.mark.parametrize("remat", [False, True])
def test_bf16_iter_step_gradients_and_stats_match_jax(bf16_iter_step, remat,
                                                      record_property):
    """Every tower gradient and running statistic under the bf16 gate
    (``test_torch_train_kernels.py``); parameters, gradients and stats
    f32, every convolution computed in bf16; with remat the same bits as
    without."""
    run = bf16_iter_step[remat]
    model = run["port"].model
    assert run["dtypes"] == {torch.bfloat16}
    grads = {}
    for name, p in model.named_parameters():
        g = run["grads"][name]
        assert p.dtype == g.dtype == torch.float32, name
        assert torch.equal(g, bf16_iter_step[False]["grads"][name]), name
        grads[name] = (g.numpy(), bf16_iter_step["want_grads"][name].numpy(),
                       bf16_iter_step["ref_grads"][name].numpy())
    record_property("gradients", assert_within_jax_bf16_noise(grads))
    stats = {name: (buf.numpy(), bf16_iter_step["want_stats"][name].numpy(),
                    bf16_iter_step["ref_stats"][name].numpy())
             for name, buf in model.named_buffers()
             if name.endswith(("running_mean", "running_var"))}
    assert all(buf.dtype == torch.float32 for buf in model.buffers())
    record_property("running_stats",
                    assert_within_jax_bf16_noise(stats, gradients=False))


@pytest.mark.parametrize("key", train_iter.METRIC_KEYS)
def test_iter_train_step_metrics_match_jax(iter_step, key):
    """The loss within rtol 1e-5; the accuracies are shares of argmax
    decisions over the batch of 2, equal."""
    got = iter_step["metrics"][key].item()
    want = float(iter_step["jmetrics"][key])
    tol = 1e-5 * abs(want) if key == "cost_volume_loss" else 1e-7
    assert abs(got - want) <= tol, (key, got, want)


def test_iter_train_step_parameters_match_jax(iter_step):
    """After the Adam step: within 1e-6 wherever JAX's gradient element is
    above 1e-3 of its tensor's max and above 1e-5 (Adam's first step moves
    each element by ``lr g / (|g| + 1e-8)``, the learning rate times its
    sign where |g| dwarfs the 1e-8, and the sign is sure there);
    elsewhere within the 2 lr a flipped sign of a near-zero f32 gradient
    element can move it. A conv bias followed by batch-statistics
    BatchNorm has a gradient of exactly 0 (the normalisation subtracts
    it), so its f32 gradient is rounding noise in both packages and Adam
    moves it by +-lr at random: held to the 2 lr only."""
    port, after, grads = (iter_step["port"], iter_step["after"],
                          iter_step["want_grads"])
    convs = port.model.cost_volume_convs
    pre_bn = {f"cost_volume_convs.{i}.bias" for i in range(len(convs) - 1)
              if isinstance(convs[i + 1], BatchNorm)}
    assert len(pre_bn) == 4
    flipped = 0
    for name, p in port.model.named_parameters():
        got, want = p.detach().numpy(), after[name].numpy()
        np.testing.assert_allclose(got, want, atol=2 * LR + 1e-6,
                                   err_msg=name)
        if name in pre_bn:
            continue
        g = np.abs(grads[name].numpy())
        sure = (g > 1e-3 * g.max()) & (g > 1e-5)
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-6,
                                   err_msg=name)
        flipped += int((np.abs(got - want) > 1e-6).sum())
    total = sum(p.numel() for p in port.model.parameters())
    assert flipped <= total // 1000, (flipped, total)
    assert port.step == 1


def test_iter_running_stats_after_the_step_match_jax(iter_step):
    for name, buf in iter_step["port"].model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), iter_step["after"][name]
                                   .numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_remat_step_leaves_the_same_state_as_a_plain_step(iter_step):
    """Two steps with ``cost_volume_remat`` against two without, from the
    same weights: every parameter, running stat and metric equal bit for
    bit (the recomputation reruns BatchNorm with its running stats frozen,
    so they move once a step, as without remat)."""
    cfg, ivars = iter_step["cfg"], iter_step["ivars"]
    st = _torch(iter_step["state"])
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, cost_volume_remat=remat)
        s = _port_state(c, ivars)
        step = train_iter.make_iter_train_step(c)
        out[remat] = ([step(s, st) for _ in range(2)],
                      s.model.state_dict())
    (m0, sd0), (m1, sd1) = out[False], out[True]
    assert sd0.keys() == sd1.keys()
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for a, b in zip(m0, m1):
        for k in train_iter.METRIC_KEYS:
            assert torch.equal(a[k], b[k]), k
    # the stats did move: not left frozen by the remat
    moved = [k for k in sd0 if k.endswith("running_mean")
             and not torch.equal(sd0[k], _port_state(cfg, ivars)
                                 .model.state_dict()[k])]
    assert moved


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_axis_accuracy_matches_jax(seed):
    """On random logits and one-hot grid labels (nlabel 5, 6 samples),
    each accuracy equal to JAX's."""
    rng = np.random.default_rng(seed)
    nl, b = 5, 6
    jcfg, cfg = jax_tiny_config(nlabel=nl), tiny_config(nlabel=nl)
    logits = rng.normal(size=(b, nl ** 3)).astype(np.float32) * 3
    label = np.zeros((b, nl ** 3), np.float32)
    label[np.arange(b), rng.integers(0, nl ** 3, size=b)] = 1.0
    want = jax_train_iter.per_axis_accuracy(jcfg, jnp.asarray(logits),
                                            jnp.asarray(label))
    got = train_iter.per_axis_accuracy(cfg, torch.from_numpy(logits),
                                       torch.from_numpy(label))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].item() == float(want[k]), k


def test_iter_train_checkpoint_round_trip(iter_step, tmp_path):
    """An ``IterTrainState`` saved after a step restores onto a fresh one
    (module, Adam moments, count); from ``model`` alone the schedule's
    position moves to the saved step and the moments stay fresh."""
    cfg, ivars = iter_step["cfg"], iter_step["ivars"]
    src = iter_step["port"]
    checkpoint.save_train_checkpoint(str(tmp_path / "ck"), src)
    dst = _port_state(cfg, ivars)
    _, restored = checkpoint.restore_train_checkpoint(str(tmp_path / "ck"),
                                                      dst)
    assert restored and dst.step == src.step == 1
    for (k, a), b in zip(src.model.state_dict().items(),
                         dst.model.state_dict().values()):
        assert torch.equal(a, b), k
    for p, q in zip(src.optimizer.params, dst.optimizer.params):
        for k, v in src.optimizer.inner.state[p].items():
            assert torch.equal(v, dst.optimizer.inner.state[q][k]), k
    os.remove(tmp_path / "ck" / "opt")
    fresh = _port_state(cfg, ivars)
    _, restored = checkpoint.restore_train_checkpoint(str(tmp_path / "ck"),
                                                      fresh)
    assert not restored and fresh.step == 1 and not fresh.optimizer.inner.state


def test_iter_train_step_descends():
    """Three steps on one state lower the loss (micro width)."""
    cfg = micro_config()
    state = _torch(_state(cfg, 3))
    s = train_iter.create_iter_state(cfg, device="cpu", seed=0)
    step = train_iter.make_iter_train_step(cfg)
    losses = [step(s, state)["cost_volume_loss"].item() for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# --------------------------------------------------------------------------
# the geo multi-step
# --------------------------------------------------------------------------

LABEL_KEYS = ("img", "pc", "node", "pt2node", "K", "P", "pc_mask", "img_mask",
              "pc_idx_for_circle_loss", "pc_xy_float_for_circle_loss",
              "pc_xy_int_for_circle_loss")


def test_geo_multi_step_matches_jax_on_the_cpu():
    """``make_geo_multi_step(S=2)`` (on the CPU a loop of the train step)
    against the JAX package's ``lax.scan`` of two steps from the same
    weights on two batches, dropout off: step 1's loss within rtol 1e-4 (the
    loss tolerance of tests/test_torch_train_geo.py), step 2's within 1e-3
    (after an Adam step whose normalised update can turn a near-zero
    gradient element's sign into a full learning-rate step)."""
    jcfg, cfg = jax_micro_config(), micro_config()
    ds = SyntheticDataset(jcfg, length=4, seed=4)
    batches = [collate([ds[2 * i], ds[2 * i + 1]]) for i in range(2)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in LABEL_KEYS}
    jb = {k: jnp.asarray(v[0]) for k, v in stacked.items()}
    variables = JaxMultiHead(jcfg).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jb,
        train=False, with_loss=True)
    tx = jax_optimizer(jcfg, 1000)
    jstate = jax_train_geo.GeoTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), tx=tx,
        apply_fn=JaxMultiHead(jcfg).apply)
    model = MultiHeadModel(cfg)
    model.load_state_dict(flax_to_state_dict(
        cfg, _numpy_tree(variables), "multihead"))
    set_dropout_rate(model, 0.0)
    port = train_geo.GeoTrainState(model, Optimizer(cfg, model.parameters(),
                                                    1000))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        jstate, jm = jax_train_geo.make_geo_multi_step(jcfg, 2)(
            jstate, {k: jnp.asarray(v) for k, v in stacked.items()},
            jax.random.key(5))
    got = train_geo.make_geo_multi_step(cfg, 2)(
        port, {k: torch.from_numpy(v) for k, v in stacked.items()},
        torch.Generator().manual_seed(5))
    want = np.asarray(jm["loss"])
    assert got["loss"].shape == (2,) and port.step == int(jstate.step) == 2
    assert set(got) == set(train_geo.METRIC_KEYS)
    np.testing.assert_allclose(got["loss"][0].item(), want[0], rtol=1e-4)
    np.testing.assert_allclose(got["loss"][1].item(), want[1], rtol=1e-3)


def test_geo_multi_step_refuses_a_mismatched_stack():
    cfg = micro_config()
    state = train_geo.create_geo_state(cfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="expected 2"):
        train_geo.make_geo_multi_step(cfg, 2)(
            state, {"pc": torch.zeros(3, 2, cfg.num_pt, 3)},
            torch.Generator())


def test_capturable_optimizer_refuses_cpu_parameters():
    """The capturable form is for CUDA parameters (a captured step); on the
    CPU it raises instead of running Adam's capturable path there."""
    cfg = micro_config()
    opt = Optimizer(cfg, [torch.nn.Parameter(torch.zeros(3))])
    with pytest.raises(ValueError, match="CUDA"):
        opt.make_capturable()
    assert not opt.capturable


def test_wrap_oracle_overlap_substitutes_the_ground_truth():
    cfg = micro_config()
    ds = SyntheticDataset(jax_micro_config(), length=2, seed=1)
    batch = {k: torch.from_numpy(v) for k, v in
             collate([ds[0], ds[1]]).items() if k in LABEL_KEYS}
    model = train_geo.create_geo_state(cfg, device="cpu", seed=0).model
    fwd = train_geo.wrap_oracle_overlap(train_geo.make_geo_forward(cfg))
    out = fwd(model, batch)
    assert torch.equal(out["pc_overlap_pred"], batch["pc_mask"].bool())
    assert torch.equal(out["pc_is_in_cam_scores"], batch["pc_mask"].float())
    plain = train_geo.make_geo_forward(cfg)(model, batch)
    assert torch.equal(out["pc_geo_feat"], plain["pc_geo_feat"])


def test_iter_train_probe_runs_on_the_cpu(capsys):
    """``tools/iter_train_probe.py`` at micro size on the CPU: one JSON
    line with both modes' step times and no memory figure."""
    import json
    from cmr_agent_tpu_torch.tools import iter_train_probe
    out = iter_train_probe.main(["--device", "cpu", "--config", "micro",
                                 "--batch", "2", "--steps", "2"])
    assert json.loads(capsys.readouterr().out.strip()) == out
    assert set(out["modes"]) == {"plain", "remat"}
    for row in out["modes"].values():
        assert len(row["step_ms"]) == 2 and row["median_ms"] > 0
        assert "peak_gib" not in row


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
