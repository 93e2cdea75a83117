"""The weight bridge, the port's data copy, and its import boundary."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cmr_agent_tpu.config import kitti_config as jax_kitti_config
from cmr_agent_tpu.config import tiny_config as jax_tiny_config
from cmr_agent_tpu.data import SyntheticDataset as JaxSyntheticDataset
from cmr_agent_tpu.models import CMRAgent as JaxAgent
from cmr_agent_tpu.models import MultiHeadModel as JaxMultiHead
from cmr_agent_tpu_torch import config as port_config
from cmr_agent_tpu_torch.data import SyntheticDataset
from cmr_agent_tpu_torch.train.convert import flax_to_state_dict

REPO = Path(__file__).resolve().parents[1]


def _template(cfg, which):
    """Zero-filled JAX variables with the real tree (shapes only, no
    forward pass)."""
    b = 1
    if which == "multihead":
        batch = {"img": jnp.zeros((b, cfg.cropped_img_h, cfg.cropped_img_w, 3)),
                 "pc": jnp.zeros((b, cfg.num_pt, 3)),
                 "node": jnp.zeros((b, cfg.num_node, 3)),
                 "pt2node": jnp.zeros((b, cfg.num_pt), jnp.int32)}
        shapes = jax.eval_shape(
            lambda: JaxMultiHead(cfg).init(
                {"params": jax.random.key(0), "dropout": jax.random.key(1)},
                batch, train=False, with_loss=False))
    else:
        f = cfg.embed_dim
        shapes = jax.eval_shape(lambda: JaxAgent(cfg).init(
            {"params": jax.random.key(0)},
            jnp.zeros((b, cfg.image_h, cfg.image_w, 2 * f)),
            jnp.zeros((b, cfg.num_pt, 5)), train=False))
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dict(shapes))


@pytest.mark.parametrize("name", ["tiny", "kitti"])
@pytest.mark.parametrize("which", ["multihead", "agent"])
def test_bridge_is_total(name, which):
    jcfg = {"tiny": jax_tiny_config, "kitti": jax_kitti_config}[name]()
    cfg = getattr(port_config, f"{name}_config")()
    variables = _template(jcfg, which)
    sd = flax_to_state_dict(cfg, variables, which)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == n_leaves


def test_bridge_rejects_missing_and_extra_leaves():
    jcfg, cfg = jax_tiny_config(), port_config.tiny_config()
    variables = _template(jcfg, "agent")
    extra = {**variables, "params": {**variables["params"],
                                     "stray": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError, match="unconsumed"):
        flax_to_state_dict(cfg, extra, "agent")
    params = dict(variables["params"])
    params.pop("value_out")
    with pytest.raises(KeyError, match="missing"):
        flax_to_state_dict(cfg, {**variables, "params": params}, "agent")


@pytest.mark.parametrize("index", [0, 3])
def test_synthetic_dataset_bit_identical(index):
    jds = JaxSyntheticDataset(jax_tiny_config(), length=4, seed=7)
    pds = SyntheticDataset(port_config.tiny_config(), length=4, seed=7)
    a, b = jds[index], pds[index]
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """Import every module of the port with jax/flax/orbax blocked, and
    OpenCV and Pillow too (the card's machine has neither); no
    ``cmr_agent_tpu`` module may get loaded."""
    code = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "flax", "orbax", "optax", "cmr_agent_tpu",
                    "cv2", "PIL"):
            raise ImportError("blocked: " + name)
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in ("jax", "jaxlib", "flax", "orbax", "optax", "cv2",
                             "PIL"):
        del sys.modules[mod]
sys.meta_path.insert(0, Block())
import cmr_agent_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cmr_agent_tpu_torch.__path__,
                                               "cmr_agent_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "flax", "orbax", "cmr_agent_tpu", "cv2",
                              "PIL")]
assert not bad, bad
for name in ("models.cost_volume", "train.train_iter", "env.environment",
             "env.episode", "models.layers", "models.agent", "ops.geometry",
             "ops.scatter", "serve", "ops.kernels", "utils.profiling",
             "tools.raster_probe", "tools.episode_trace", "tools.train_probe",
             "cli.common", "cli.test_agent", "cli.test_geo",
             "cli.train_geo", "cli.train_agent", "cli.train_iter",
             "train.checkpoint", "train.metrics", "train.export",
             "train.train_geo", "train.train_agent", "train.optim",
             "data.loader", "native", "data.augment", "data.kitti",
             "data.nuscenes", "data.label_mapping", "data.smoke",
             "models.gnn", "examples.convergence_demo",
             "tools.multichip_dryrun"):
    assert "cmr_agent_tpu_torch." + name in names, name
print("imported", len(names))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) >= 17
