"""The port's geo model and agent vs the JAX package on ``tiny_config()``
in f32.

Weights come from the JAX package's ``init`` and reach the port through
the weight bridge (``flax_to_state_dict``); the batch is the synthetic
dataset's, made with numpy from a seed. The JAX side runs its CPU route
(XLA fallbacks of the kernels); the port runs its plain kernel versions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmr_agent_tpu.config import tiny_config as jax_tiny_config
from cmr_agent_tpu.data import SyntheticDataset, collate
from cmr_agent_tpu.models import CMRAgent as JaxAgent
from cmr_agent_tpu.models import MultiHeadModel as JaxMultiHead
from cmr_agent_tpu.models.layers import ViTCrossBlock as JaxCrossBlock
from cmr_agent_tpu.models.point_encoder import \
    PointTransformer as JaxPointTransformer
from cmr_agent_tpu_torch.config import tiny_config
from cmr_agent_tpu_torch.models.agent import CMRAgent
from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
from cmr_agent_tpu_torch.train.convert import flax_to_state_dict

ATOL = 1e-4
KEYS = ("img", "pc", "node", "pt2node", "K", "P")


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_tiny_config(), tiny_config()
    ds = SyntheticDataset(jcfg, length=2, seed=3)
    batch_np = {k: v for k, v in collate([ds[0], ds[1]]).items() if k in KEYS}
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    model = JaxMultiHead(jcfg)
    variables = model.init({"params": jax.random.key(0),
                            "dropout": jax.random.key(1)}, jbatch,
                           train=False, with_loss=False)
    # perturb the BN running stats so eval BatchNorm is exercised
    rng = np.random.default_rng(5)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.2, a.shape).astype(
            np.float32), variables["batch_stats"])
    variables = {"params": _numpy_tree(variables["params"]),
                 "batch_stats": stats}
    want = model.apply(variables, jbatch, train=False, with_loss=False)
    port = MultiHeadModel(cfg).eval()
    port.load_state_dict(flax_to_state_dict(cfg, variables, "multihead"))
    tbatch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    with torch.no_grad():
        got = port(tbatch)
    return dict(jcfg=jcfg, cfg=cfg, variables=variables, jbatch=jbatch,
                tbatch=tbatch, want=want, got=got, port=port)


def test_vit_cross_block_matches_jax(setup):
    params = setup["variables"]["params"]["encoder_decoder"]["encoder"]["p2i_0"]
    jcfg = setup["jcfg"]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 7, jcfg.embed_dim)).astype(np.float32)
    y = rng.normal(size=(2, 11, jcfg.embed_dim)).astype(np.float32)
    want = JaxCrossBlock(jcfg.num_head, jcfg.mlp_dim, 0.0, 0.0).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(y), False)
    blk = setup["port"].encoder_decoder.encoder.p2i_ca_layers[0]
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_point_transformer_matches_jax(setup):
    enc = setup["variables"]
    sub = {c: enc[c]["encoder_decoder"]["encoder"]["pt_transformer"]
           for c in ("params", "batch_stats")}
    jb, tb = setup["jbatch"], setup["tbatch"]
    want = JaxPointTransformer(setup["jcfg"]).apply(
        sub, jb["pc"], jb["node"], jb["pt2node"], False)
    pt = setup["port"].encoder_decoder.encoder.pt_transformer
    with torch.no_grad():
        got = pt(tb["pc"], tb["node"], tb["pt2node"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("key", ["pc_geo_feat", "img_geo_feat",
                                 "pc_overlap_logits", "img_overlap_logits"])
def test_multihead_outputs_match_jax(setup, key):
    got, want = setup["got"][key].numpy(), np.asarray(setup["want"][key])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_multihead_overlap_pred_matches_jax(setup):
    got = setup["got"]["pc_overlap_pred"].numpy()
    want = np.asarray(setup["want"]["pc_overlap_pred"])
    p = np.asarray(setup["want"]["pc_is_in_cam_scores"])
    near = np.abs(p - 0.5) < 1e-4
    np.testing.assert_array_equal(got[~near], want[~near])
    np.testing.assert_allclose(setup["got"]["pc_is_in_cam_scores"].numpy(),
                               p, atol=ATOL)


def test_agent_logits_match_jax():
    jcfg, cfg = jax_tiny_config(), tiny_config()
    rng = np.random.default_rng(8)
    b, f = 2, jcfg.embed_dim
    o2 = rng.normal(size=(b, jcfg.image_h, jcfg.image_w, 2 * f)).astype(
        np.float32)
    o3 = np.concatenate([rng.normal(size=(b, 300, 3)) * 5,
                         rng.integers(0, 2, size=(b, 300, 2))], -1).astype(
        np.float32)
    agent = JaxAgent(jcfg)
    variables = _numpy_tree(agent.init({"params": jax.random.key(2)},
                                       jnp.asarray(o2), jnp.asarray(o3),
                                       train=False))
    want = agent.apply(variables, jnp.asarray(o2), jnp.asarray(o3),
                       train=False)
    port = CMRAgent(cfg).eval()
    port.load_state_dict(flax_to_state_dict(cfg, variables, "agent"))
    with torch.no_grad():
        got = port(torch.from_numpy(o2), torch.from_numpy(o3))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
