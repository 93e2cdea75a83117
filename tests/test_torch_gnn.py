"""The GNN-embedding variant (``use_gnn_embedding=True``) of the port's geo
model against the JAX package's on ``micro_config``, on the CPU.

With the option set, the JAX package embeds the raw points with the
EdgeConv ``MiniGNN`` over the batch's host knn (``pc_knn``) plus a
positional MLP (``models/point_encoder.py:144-160``). The port used to
accept the option and run its plain point MLP all the same, and its weight
bridge could not carry the variant's tree: ``test_gnn_geo_outputs_match_jax``
fails there.

Weights are drawn at random over the shapes of the JAX ``init`` (traced
only) and reach the port through the weight bridge; the batch is the JAX
synthetic dataset's with the option on. Forward outputs within
``test_torch_geo.py``'s ATOL 1e-4; the train-mode losses within rtol 1e-4
and every gradient within 1e-4 of its tensor's max at f64 compute, as
``test_torch_train_geo.py`` holds the plain model (dropout off on both
sides).
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
from cmr_agent_tpu.models.gnn import MiniGNN as JaxMiniGNN
from cmr_agent_tpu.models.gnn import SiameseResMLP as JaxSiameseResMLP
from cmr_agent_tpu_torch.config import Config, micro_config
from cmr_agent_tpu_torch.models.gnn import MiniGNN, SiameseResMLP
from cmr_agent_tpu_torch.models.layers import set_dropout_rate
from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
from cmr_agent_tpu_torch.train import train_geo
from cmr_agent_tpu_torch.train.convert import (_MapBuilder,
                                               entries_to_state_dict,
                                               flax_to_state_dict,
                                               multihead_name_map)

ATOL = 1e-4
KEYS = ("img", "pc", "node", "pt2node", "pc_knn", "pc_mask", "img_mask",
        "pc_idx_for_circle_loss", "pc_xy_float_for_circle_loss",
        "pc_xy_int_for_circle_loss")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class F64Numpy:
    """``jax.numpy`` with ``float32`` standing for ``float64`` (the JAX
    BatchNorm wrapper then normalises in f64), as in
    ``test_torch_train_geo.py``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _random_variables(init, seed):
    """Variables over the tree of ``init()`` (traced for shapes only):
    kernels at fan-in scale, BatchNorm scale, bias and statistics at
    random (an initialised BatchNorm is the identity)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(init))


def _batch(cfg):
    ds = SyntheticDataset(cfg, length=2, seed=4)
    b = collate([ds[0], ds[1]])
    return {k: b[k] for k in KEYS}


@pytest.fixture(scope="module")
def model():
    jcfg = jax_micro_config(use_gnn_embedding=True)
    cfg = micro_config(use_gnn_embedding=True)
    batch_np = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jmodel = JaxMultiHead(jcfg)
    variables = _random_variables(lambda: jmodel.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jb,
        train=False, with_loss=False), 5)
    want = jmodel.apply(variables, jb, train=False, with_loss=True)
    port = MultiHeadModel(cfg).eval()
    port.load_state_dict(flax_to_state_dict(cfg, variables, "multihead"))
    tb = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    with torch.no_grad():
        got = port(tb, with_loss=True)
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, variables=variables,
                batch_np=batch_np, jb=jb, tb=tb, want=want, got=got)


@pytest.mark.parametrize("key", ["pc_geo_feat", "img_geo_feat",
                                 "pc_overlap_logits", "img_overlap_logits",
                                 "pt_feat", "node_feat"])
def test_gnn_geo_outputs_match_jax(model, key):
    """The failing-first test of the repair: with the option set, the
    port's geo outputs equal the JAX model's (eval mode)."""
    got, want = model["got"][key].numpy(), np.asarray(model["want"][key])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_gnn_eval_losses_match_jax(model):
    for key in ("pc_overlap_loss", "img_overlap_loss", "geometric_loss",
                "loss"):
        want = float(model["want"][key])
        assert abs(model["got"][key].item() - want) <= 1e-4 * abs(want) \
            + 1e-6, key


def test_gnn_needs_pc_knn(model):
    port = MultiHeadModel(model["cfg"]).eval()
    tb = {k: v for k, v in model["tb"].items() if k != "pc_knn"}
    with pytest.raises(ValueError, match="pc_knn"):
        port(tb)


def test_bridge_is_total_with_the_variant():
    """Every leaf of the variant's tree maps, the standard map names none
    of the variant's modules, and a tree without them raises."""
    cfg = micro_config(use_gnn_embedding=True)
    jcfg = jax_micro_config(use_gnn_embedding=True)
    b = jax_micro_config()
    batch = {"img": jnp.zeros((2, b.cropped_img_h, b.cropped_img_w, 3)),
             "pc": jnp.zeros((2, b.num_pt, 3)),
             "node": jnp.zeros((2, b.num_node, 3)),
             "pt2node": jnp.zeros((2, b.num_pt), jnp.int32),
             "pc_knn": jnp.zeros((2, b.num_pt, b.knn_k), jnp.int32)}
    shapes = jax.eval_shape(lambda: JaxMultiHead(jcfg).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, batch,
        train=False, with_loss=False))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    sd = flax_to_state_dict(cfg, variables, "multihead")
    assert len(sd) == len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == len(MultiHeadModel(cfg).state_dict())
    plain = {e[0] for e in multihead_name_map(micro_config())}
    gnn = {e[0] for e in multihead_name_map(cfg)} - plain
    assert gnn and all(".mini_gnn." in k or ".pos_embed_" in k for k in gnn)
    with pytest.raises(KeyError, match="unconsumed"):
        flax_to_state_dict(micro_config(), variables, "multihead")
    pt = variables["params"]["encoder_decoder"]["encoder"]["pt_transformer"]
    del pt["mini_gnn"]
    with pytest.raises(KeyError, match="missing"):
        flax_to_state_dict(cfg, variables, "multihead")


@pytest.mark.parametrize("train", [False, True])
def test_mini_gnn_matches_jax(train):
    """The module alone, in eval mode (running statistics) and in train
    mode (batch statistics, and the running statistics it writes)."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 300, 3)).astype(np.float32) * 3
    knn = rng.integers(0, 300, size=(2, 300, 6)).astype(np.int32)
    jm = JaxMiniGNN(out_features=32)
    variables = _random_variables(lambda: jm.init(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(knn), False), 11)
    want, mutated = jm.apply(variables, jnp.asarray(x), jnp.asarray(knn),
                             train, mutable=["batch_stats"])
    port = MiniGNN(3, 64, 32)
    b = _MapBuilder()
    b.mini_gnn("m", "")
    entries = [(tk[2:], c, fp.lstrip("/"), tag) for tk, c, fp, tag in b.entries]
    port.load_state_dict(entries_to_state_dict(entries, port.state_dict(),
                                                variables))
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(knn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if train:
        stats = entries_to_state_dict(
            entries, port.state_dict(),
            {"params": variables["params"],
             "batch_stats": mutated["batch_stats"]})
        for name, buf in port.named_buffers():
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("cin", [8, 6])
def test_siamese_res_mlp_matches_jax(cin):
    """Identity shortcuts throughout (``cin`` = features) and a projected
    first block."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 50, cin)).astype(np.float32)
    jm = JaxSiameseResMLP(8, 3)
    variables = _random_variables(
        lambda: jm.init(jax.random.key(0), jnp.asarray(x)), 12)
    want = jm.apply(variables, jnp.asarray(x))
    port = SiameseResMLP(8, 3, cin=cin).eval()
    b = _MapBuilder()
    for i in range(3):
        b.res_dense(f"res.{i}", f"res_{i}", shortcut=i == 0 and cin != 8)
    b.dense("out_0", "out_0")
    b.bn("out_bn", "out_bn")
    b.dense("out_1", "out_1")
    port.load_state_dict(entries_to_state_dict(b.entries, port.state_dict(),
                                               variables))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.fixture(scope="module")
def step(model):
    """One train-mode forward + backward of both models from the same
    weights and batch (dropout off): f32 for the losses and the running
    statistics, f64 compute for the gradients."""
    jmodel, jb, cfg = model["jmodel"], model["jb"], model["cfg"]
    params = model["variables"]["params"]
    stats = model["variables"]["batch_stats"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        jout, mutated = jmodel.apply(
            {"params": params, "batch_stats": stats}, jb, train=True,
            with_loss=True, mutable=["batch_stats"])
        mp.setattr(JaxConfig, "jnp_dtype", lambda self: jnp.float64)
        mp.setattr(jax_layers, "jnp", F64Numpy())
        with jax.enable_x64(True):
            f64 = lambda t: jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64)
                if np.asarray(a).dtype == np.float32 else jnp.asarray(a), t)
            grads = jax.grad(lambda p: jmodel.apply(
                {"params": p, "batch_stats": f64(stats)}, f64(jb),
                train=True, with_loss=True, mutable=["batch_stats"]
            )[0]["loss"])(f64(params))
            grads = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32), grads)

    def port_model():
        m = MultiHeadModel(cfg)
        m.load_state_dict(flax_to_state_dict(cfg, model["variables"],
                                             "multihead"))
        set_dropout_rate(m, 0.0)
        return m.train()

    port = port_model()
    out = port(model["tb"], with_loss=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Config, "torch_dtype", lambda self: torch.float64)
        port64 = port_model()
    port64(model["tb"], with_loss=True)["loss"].backward()
    want_grads = flax_to_state_dict(
        cfg, {"params": grads, "batch_stats": stats}, "multihead")
    want_stats = flax_to_state_dict(
        cfg, {"params": params, "batch_stats": mutated["batch_stats"]},
        "multihead")
    return dict(port=port, port64=port64, out=out, jout=jout,
                want_grads=want_grads, want_stats=want_stats)


@pytest.mark.parametrize("key", ["pc_overlap_loss", "img_overlap_loss",
                                 "geometric_loss", "loss"])
def test_gnn_train_losses_match_jax(step, key):
    want = float(step["jout"][key])
    assert abs(step["out"][key].item() - want) <= 1e-4 * abs(want) + 1e-6


def test_gnn_every_gradient_matches_jax(step):
    """Per tensor within 1e-4 max|g| + 1e-6 of the JAX gradient, both at
    f64 compute; the variant's own parameters among them."""
    names = [n for n, _ in step["port64"].named_parameters()]
    assert any(".mini_gnn.edge_convs.4." in n for n in names)
    for name, p in step["port64"].named_parameters():
        want = step["want_grads"][name].numpy()
        tol = 1e-4 * np.abs(want).max() + 1e-6
        assert np.abs(p.grad.numpy() - want).max() <= tol, name


def test_gnn_batchnorm_stats_after_the_step_match_jax(step):
    for name, buf in step["port"].named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(),
                                       step["want_stats"][name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_gnn_train_step_runs_on_cpu(model):
    """The port's geo train step takes the variant's batch (``pc_knn``
    rides along) and moves the EdgeConv weights."""
    cfg = model["cfg"]
    state = train_geo.create_geo_state(cfg, device="cpu")
    w0 = state.model.encoder_decoder.encoder.pt_transformer.embeddings \
        .mini_gnn.edge_convs[0].layer[0].weight.detach().clone()
    metrics = train_geo.make_geo_train_step(cfg)(
        state, model["tb"], torch.Generator().manual_seed(0))
    assert np.isfinite(metrics["loss"].item())
    w1 = state.model.encoder_decoder.encoder.pt_transformer.embeddings \
        .mini_gnn.edge_convs[0].layer[0].weight
    assert not torch.equal(w0, w1)
