"""The reference's ``.pth`` checkpoints into the port, against the JAX
package's ``convert_torch_*`` on the same files, on the CPU.

A reference-layout state dict (``chip_smoke.reference_state_dict``:
pointwise weights as ``Conv1d [O, I, 1]``, the IterModel tower as
``Conv3d [O, I, 1, kh, kw]``, ``num_batches_tracked``, the image
``Embeddings``' alias keys and ``position_embeddings``) is saved with
``torch.save`` and read by both packages. The geo model's forward and the
agent's logits agree within ``test_torch_geo.py``'s ATOL 1e-4; every
imported tensor equals the one the JAX tree gives through the port's weight
bridge, bit for bit. A missing key, a surplus key and an alias that
differs from its original raise. The committed weight exports round-trip
through ``.pth`` bit for bit, and every CLI flag where the JAX package
takes a ``.pth`` loads one.
"""

import argparse

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from cmr_agent_tpu.config import micro_config as jax_micro_config
from cmr_agent_tpu.data import SyntheticDataset, collate
from cmr_agent_tpu.models import CMRAgent as JaxAgent
from cmr_agent_tpu.models import IterModel as JaxIterModel
from cmr_agent_tpu.models import MultiHeadModel as JaxMultiHead
from cmr_agent_tpu.train import convert as jax_convert
from cmr_agent_tpu_torch.cli import common
from cmr_agent_tpu_torch.config import kitti_config, micro_config
from cmr_agent_tpu_torch.models.agent import CMRAgent
from cmr_agent_tpu_torch.models.cost_volume import IterModel
from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
from cmr_agent_tpu_torch.train.checkpoint import load_module_variables, \
    restore_model_variables
from cmr_agent_tpu_torch.train.convert import (convert_torch_agent,
                                               convert_torch_itermodel,
                                               convert_torch_multihead,
                                               flax_to_state_dict)

ATOL = 1e-4
KEYS = ("img", "pc", "node", "pt2node")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_variables(init, seed):
    """Variables over the tree of ``init()`` (traced for shapes only) with
    random kernels, biases and BatchNorm statistics."""
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
    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


def _pth(tmp_path, cfg, variables, which, name):
    """The reference-layout ``.pth`` of JAX ``variables``; its path."""
    sd = flax_to_state_dict(cfg, variables, which)
    path = tmp_path / name
    torch.save(chip_smoke.reference_state_dict(torch, sd, which), path)
    return str(path), sd


@pytest.fixture(scope="module")
def batch():
    ds = SyntheticDataset(jax_micro_config(), length=2, seed=6)
    return {k: v for k, v in collate([ds[0], ds[1]]).items() if k in KEYS}


@pytest.fixture(scope="module")
def geo(tmp_path_factory, batch):
    jcfg, cfg = jax_micro_config(), micro_config()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JaxMultiHead(jcfg)
    init = lambda: model.init({"params": jax.random.key(0),
                               "dropout": jax.random.key(1)}, jb,
                              train=False, with_loss=False)
    variables = _random_variables(init, 3)
    path, sd = _pth(tmp_path_factory.mktemp("pth"), cfg, variables,
                    "multihead", "geo_feat.pth")
    return dict(jcfg=jcfg, cfg=cfg, model=model, variables=variables,
                path=path, sd=sd, jb=jb)


def test_geo_pth_forward_matches_jax(geo):
    """``geo_feat.pth`` through both packages' import: the same outputs."""
    template = {c: geo["variables"][c] for c in ("params", "batch_stats")}
    jvars = jax_convert.convert_torch_multihead(geo["jcfg"], geo["path"],
                                                template)
    want = geo["model"].apply(jvars, geo["jb"], train=False, with_loss=False)
    port = MultiHeadModel(geo["cfg"]).eval()
    port.load_state_dict(convert_torch_multihead(geo["cfg"], geo["path"]))
    with torch.no_grad():
        got = port({k: torch.from_numpy(np.array(v))
                    for k, v in geo["jb"].items()})
    for key in ("pc_geo_feat", "img_geo_feat", "pc_overlap_logits",
                "img_overlap_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, err_msg=key)


def test_geo_pth_import_equals_the_bridge(geo):
    """Each imported tensor is the one the JAX package's import of the same
    file gives through the port's weight bridge, bit for bit."""
    template = {c: geo["variables"][c] for c in ("params", "batch_stats")}
    jvars = jax_convert.convert_torch_multihead(geo["jcfg"], geo["path"],
                                                template)
    want = flax_to_state_dict(geo["cfg"], jvars, "multihead")
    got = convert_torch_multihead(geo["cfg"], geo["path"])
    assert got.keys() == want.keys() == geo["sd"].keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_agent_pth_matches_jax(tmp_path):
    jcfg, cfg = jax_micro_config(), micro_config()
    rng = np.random.default_rng(8)
    f = jcfg.embed_dim
    o2 = rng.normal(size=(2, jcfg.image_h, jcfg.image_w, 2 * f)).astype(
        np.float32)
    o3 = np.concatenate([rng.normal(size=(2, 300, 3)) * 5,
                         rng.integers(0, 2, size=(2, 300, 2))], -1).astype(
        np.float32)
    agent = JaxAgent(jcfg)
    variables = _random_variables(lambda: agent.init(
        {"params": jax.random.key(2)}, jnp.asarray(o2), jnp.asarray(o3),
        train=False), 4)
    path, _ = _pth(tmp_path, cfg, variables, "agent", "agent.pth")
    jvars = jax_convert.convert_torch_agent(jcfg, path, variables)
    want = agent.apply(jvars, jnp.asarray(o2), jnp.asarray(o3), train=False)
    port = CMRAgent(cfg).eval()
    port.load_state_dict(convert_torch_agent(cfg, path))
    with torch.no_grad():
        got = port(torch.from_numpy(o2), torch.from_numpy(o3))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    bridged = flax_to_state_dict(cfg, jvars, "agent")
    for k, v in convert_torch_agent(cfg, path).items():
        assert torch.equal(v, bridged[k]), k


def test_itermodel_pth_matches_jax(tmp_path):
    """The IterModel's Conv3d tower: the same tensors as JAX's import."""
    jcfg, cfg = jax_micro_config(), micro_config()
    f, h, w = jcfg.embed_dim, jcfg.image_h, jcfg.image_w
    zeros = lambda *s: jnp.zeros(s)
    state = {"pc_i": zeros(1, jcfg.num_pt, 3), "K": zeros(1, 3, 3),
             "img_geo_feat": zeros(1, h, w, f),
             "pc_geo_feat": zeros(1, jcfg.num_pt, f),
             "pc_overlap_pred": zeros(1, jcfg.num_pt) > 0,
             "pc_is_in_cam_scores": zeros(1, jcfg.num_pt),
             "img_overlap_pred": zeros(1, h, w),
             "R_amplitude": zeros(1), "T_amplitude": zeros(1),
             "matrix_accumulated": zeros(1, 4, 4)}
    model = JaxIterModel(jcfg)
    variables = _random_variables(lambda: model.init(
        {"params": jax.random.key(0)}, state, train=False, with_loss=False),
        5)
    path, sd = _pth(tmp_path, cfg, variables, "itermodel", "iter.pth")
    raw = torch.load(path, weights_only=True)
    assert raw["cost_volume_convs.0.weight"].ndim == 5
    jvars = jax_convert.convert_torch_itermodel(jcfg, path, variables)
    want = flax_to_state_dict(cfg, jvars, "itermodel")
    got = convert_torch_itermodel(cfg, path)
    assert got.keys() == want.keys() == sd.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    IterModel(cfg).load_state_dict(got, strict=True)


def test_pth_import_is_total(geo):
    raw = torch.load(geo["path"], weights_only=True)
    alias = [k for k in raw if ".embedding_layers." in k]
    assert alias and any(k.endswith("num_batches_tracked") for k in raw)
    missing = dict(raw)
    del missing["geo_head.pc_geo_head.0.weight"]
    with pytest.raises(KeyError, match="missing"):
        convert_torch_multihead(geo["cfg"], missing)
    surplus = dict(raw, **{"geo_head.extra.weight": torch.zeros(2, 2)})
    with pytest.raises(KeyError, match="unconsumed"):
        convert_torch_multihead(geo["cfg"], surplus)
    # the JAX package's import raises on both too
    template = {c: geo["variables"][c] for c in ("params", "batch_stats")}
    for bad in ({k: v.numpy() for k, v in missing.items()},
                {k: v.numpy() for k, v in surplus.items()}):
        with pytest.raises(KeyError):
            jax_convert.convert_torch_multihead(geo["jcfg"], bad, template)
    differs = dict(raw)
    differs[alias[0]] = raw[alias[0]] + 1.0
    with pytest.raises(ValueError, match="differs"):
        convert_torch_multihead(geo["cfg"], differs)
    shape = dict(raw)
    shape["geo_head.pc_geo_head.0.weight"] = torch.zeros(3, 3, 1)
    with pytest.raises(ValueError, match="shape"):
        convert_torch_multihead(geo["cfg"], shape)


@pytest.mark.parametrize("stem, which", [("geo_pi", "multihead"),
                                         ("agent_45", "agent"),
                                         ("iter_kitti_epoch-1-step-10000",
                                          "itermodel")])
def test_committed_exports_round_trip_through_pth(tmp_path, stem, which):
    """A committed weight export written as a reference ``.pth`` and loaded
    through ``cli.common.load_model`` (every CLI's loader) equals the
    export's own load, bit for bit."""
    cfg = kitti_config(**chip_smoke.FLAGSHIP_CFG)
    make = {"multihead": MultiHeadModel, "agent": CMRAgent,
            "itermodel": IterModel}[which]
    want = load_module_variables(make(cfg), cfg, restore_model_variables(
        f"cmr_agent_tpu_torch/weights/{stem}.npz"), which)
    path = tmp_path / f"{stem}.pth"
    torch.save(chip_smoke.reference_state_dict(torch, want.state_dict(),
                                               which), path)
    got = common.load_model(cfg, make(cfg), str(path), which, "x", "cpu")
    sd = want.state_dict()
    assert got.state_dict().keys() == sd.keys()
    for k, v in got.state_dict().items():
        assert torch.equal(v, sd[k]), k


class _Loaded(Exception):
    """Raised where a CLI has loaded every checkpoint it was given."""


def test_every_pth_flag_loads(tmp_path, monkeypatch):
    """Each CLI flag where the JAX CLIs take a ``.pth`` reads one through
    the import: ``--geo-ckpt`` (every CLI that has it), ``--fine-geo-ckpt``,
    ``--agent-ckpt`` and ``--iter-ckpt``; each CLI is stopped right after
    its loads."""
    from cmr_agent_tpu_torch import serve
    from cmr_agent_tpu_torch.cli import (test_agent, test_geo, train_agent,
                                         train_iter)
    from cmr_agent_tpu_torch.config import tiny_config
    from cmr_agent_tpu_torch.train import convert
    cfg = tiny_config()
    paths = {}
    for which, make in (("multihead", MultiHeadModel), ("agent", CMRAgent),
                        ("itermodel", IterModel)):
        paths[which] = str(tmp_path / f"{which}.pth")
        torch.save(chip_smoke.reference_state_dict(
            torch, make(cfg).state_dict(), which), paths[which])
    loads = []
    real = convert.torch_to_state_dict

    def recorded(cfg, path, which):
        loads.append((path, which))
        return real(cfg, path, which)

    def stop(*a, **k):
        raise _Loaded

    monkeypatch.setattr(convert, "torch_to_state_dict", recorded)
    monkeypatch.setattr(serve, "CoarseToFine", stop)
    monkeypatch.setattr(test_geo, "iter_model_state", stop)
    for mod in (train_agent, train_iter):
        monkeypatch.setattr(mod, "make_geo_forward", stop)
    base = ["--tiny", "--device", "cpu", "--synthetic-length", "2",
            "--num-workers", "0", "--geo-ckpt", paths["multihead"]]
    for mod, extra, want in (
            (test_agent, ["--fine-geo-ckpt", paths["multihead"],
                          "--agent-ckpt", paths["agent"], "--iter-ckpt",
                          paths["itermodel"]],
             ["multihead", "multihead", "agent", "itermodel"]),
            (test_geo, ["--iter-ckpt", paths["itermodel"]],
             ["multihead", "itermodel"]),
            (train_agent, [], ["multihead"]),
            (train_iter, [], ["multihead"])):
        loads.clear()
        with pytest.raises(_Loaded):
            mod.main(base + extra)
        assert loads == [(paths[w], w) for w in want], mod.__name__
