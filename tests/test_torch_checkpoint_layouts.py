"""Every checkpoint layout the port writes loads back into the port: a train
checkpoint directory (``path/model`` and ``path/opt``, torch.save files),
a stepless model snapshot (``path/model`` alone, the convergence demo's
``--save-geo`` / ``--save-agent``) and, as before, a weight export or the
Orbax tree it came from; an Orbax tree without an export still raises.
The CLIs chain on the CPU at the micro size: ``cli.train_geo`` ->
``cli.train_agent --geo-ckpt`` -> ``cli.test_agent --geo-ckpt
--agent-ckpt``, as in the JAX package.

Torch only on the port's side; the JAX package is not needed here."""

import glob
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from cmr_agent_tpu_torch.cli import common
from cmr_agent_tpu_torch.cli import test_agent as cli_test_agent
from cmr_agent_tpu_torch.cli import train_agent as cli_train_agent
from cmr_agent_tpu_torch.cli import train_geo as cli_train_geo
from cmr_agent_tpu_torch.config import micro_config
from cmr_agent_tpu_torch.models.agent import CMRAgent
from cmr_agent_tpu_torch.models.cost_volume import IterModel
from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
from cmr_agent_tpu_torch.serve import init_random_
from cmr_agent_tpu_torch.train import checkpoint
from cmr_agent_tpu_torch.train.convert import (flax_to_state_dict,
                                               state_dict_to_flax)
from cmr_agent_tpu_torch.train.train_agent import create_agent_state
from cmr_agent_tpu_torch.train.train_geo import create_geo_state

REPO = Path(__file__).resolve().parents[1]
MODULES = {"multihead": MultiHeadModel, "agent": CMRAgent,
           "itermodel": IterModel}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_module(which, seed=3):
    """A micro module with random weights and BatchNorm statistics that
    differ from their init, so a restore that dropped them would show."""
    cfg = micro_config()
    module = MODULES[which](cfg)
    init_random_(module, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in module.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.add_(torch.rand(buf.shape, generator=gen))
    return cfg, module


def _assert_same_bits(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].cpu(), want[k].cpu()), k


@pytest.mark.parametrize("which", sorted(MODULES))
def test_the_bridge_inverts_to_the_same_bits(which):
    """``state_dict_to_flax`` then ``flax_to_state_dict`` gives the port
    tensors back bit for bit (the layout transforms are transposes);
    a missing or unknown key raises."""
    cfg, module = _random_module(which)
    sd = module.state_dict()
    variables = state_dict_to_flax(cfg, sd, which)
    assert set(variables) == {"params", "batch_stats"}
    _assert_same_bits(flax_to_state_dict(cfg, variables, which), sd)
    with pytest.raises(KeyError, match="missing"):
        state_dict_to_flax(cfg, dict(list(sd.items())[1:]), which)
    with pytest.raises(KeyError, match="unknown"):
        state_dict_to_flax(cfg, {**sd, "stray.weight": torch.zeros(1)}, which)


@pytest.mark.parametrize("layout", ["train", "snapshot"])
@pytest.mark.parametrize("which", ["multihead", "agent"])
def test_port_layouts_load_with_the_same_bits(tmp_path, layout, which):
    """A train checkpoint and a stepless snapshot each load through
    ``restore_state_dict``, ``cli.common.load_model`` and (laid out as the
    JAX package does, then bridged) ``restore_model_variables`` to the
    saved module's bits; ``saved_tree_keys`` tells the two apart."""
    cfg, module = _random_module(which)
    path = str(tmp_path / layout)
    if layout == "train":
        state = (create_geo_state if which == "multihead"
                 else create_agent_state)(cfg, "cpu", seed=5)
        target = state.model if which == "multihead" else state.agent
        target.load_state_dict(module.state_dict())
        checkpoint.save_train_checkpoint(path, state)
        assert checkpoint.saved_tree_keys(path) == {"module", "step"}
    else:
        checkpoint.save_model_snapshot(path, module.state_dict())
        assert checkpoint.saved_tree_keys(path) == {"module"}
        assert os.listdir(path) == ["model"]
    want = module.state_dict()
    _assert_same_bits(checkpoint.restore_state_dict(path, cfg, which), want)
    loaded = common.load_model(cfg, MODULES[which](cfg), path, which, "x",
                               "cpu")
    assert not loaded.training
    _assert_same_bits(loaded.state_dict(), want)
    variables = checkpoint.restore_model_variables(path, cfg, which)
    assert ("step" in variables) == (layout == "train")
    _assert_same_bits(flax_to_state_dict(
        cfg, {k: variables[k] for k in ("params", "batch_stats")}, which),
        want)
    with pytest.raises(ValueError, match="name the module"):
        checkpoint.restore_model_variables(path)


def test_a_snapshot_replaces_the_previous_one_whole(tmp_path):
    cfg, first = _random_module("agent", seed=1)
    _, second = _random_module("agent", seed=2)
    path = str(tmp_path / "snap")
    checkpoint.save_model_snapshot(path, first.state_dict())
    checkpoint.save_model_snapshot(path, second.state_dict())
    assert os.listdir(path) == ["model"]
    _assert_same_bits(checkpoint.restore_state_dict(path, cfg, "agent"),
                      second.state_dict())


def test_a_stepless_snapshot_resumes_with_fresh_optimizer_state(tmp_path):
    """``restore_train_checkpoint`` on a snapshot: the weights and
    statistics restored, the step and Adam's moments left fresh
    (``opt_restored`` False), as the JAX package restores a demo
    snapshot."""
    cfg, module = _random_module("agent")
    path = str(tmp_path / "snap")
    checkpoint.save_model_snapshot(path, module.state_dict())
    state = create_agent_state(cfg, "cpu", seed=9)
    state, opt_restored = checkpoint.restore_train_checkpoint(path, state)
    assert not opt_restored
    assert state.step == 0 and not state.optimizer.inner.state
    _assert_same_bits(state.agent.state_dict(), module.state_dict())
    with pytest.raises(FileNotFoundError, match="no port train checkpoint"):
        checkpoint.restore_train_checkpoint(str(tmp_path / "none"), state)


def test_an_orbax_tree_without_an_export_still_raises():
    """An Orbax ``model/`` is a directory, not a port file: the un-exported
    tree raises naming the exporter, through every reader."""
    tree = str(REPO / "checkpoint/iter_kitti/epoch-0-step-10500")
    assert os.path.isdir(os.path.join(tree, "model"))
    assert checkpoint.port_model_file(tree) is None
    cfg = micro_config()
    for call in (lambda: checkpoint.restore_model_variables(tree),
                 lambda: checkpoint.restore_state_dict(tree, cfg,
                                                       "itermodel"),
                 lambda: common.load_model(cfg, IterModel(cfg), tree,
                                           "itermodel", "iter", "cpu")):
        with pytest.raises(FileNotFoundError, match="export_torch_weights"):
            call()
    exported = str(REPO / "runs_r4/geo_45")
    assert checkpoint.port_model_file(exported) is None
    assert checkpoint.export_path(exported).name == "geo_45.npz"


@pytest.fixture
def micro_clis(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "tiny_config", micro_config)

    def argv(*extra):
        return ["--tiny", "--device", "cpu", "--synthetic-length", "4",
                "--val-length", "2", "--loader-backend", "sync",
                "--logdir", str(tmp_path / "log")] + list(extra)
    return argv


def _saved(root):
    return sorted(os.path.dirname(p) for p in glob.glob(
        os.path.join(root, "**", "model"), recursive=True))


def test_the_cli_chain_runs_on_port_checkpoints(micro_clis, tmp_path,
                                                capsys):
    """``train_geo`` -> ``train_agent --geo-ckpt`` (its train checkpoint)
    -> ``test_agent --geo-ckpt --agent-ckpt``, each CLI loading the
    previous one's directory with the saved bits."""
    geo_state = cli_train_geo.main(micro_clis(
        "--steps", "2", "--ckpt-dir", str(tmp_path / "geo")))
    (geo_dir,) = _saved(str(tmp_path / "geo"))
    agent_state = cli_train_agent.main(micro_clis(
        "--steps", "2", "--ckpt-dir", str(tmp_path / "agent"),
        "--geo-ckpt", geo_dir))
    (agent_dir,) = _saved(str(tmp_path / "agent"))
    metrics = cli_test_agent.main(micro_clis(
        "--geo-ckpt", geo_dir, "--agent-ckpt", agent_dir,
        "--max-batches", "1"))
    out = capsys.readouterr().out
    assert f"loaded geo checkpoint from {geo_dir}" in out
    assert f"loaded agent checkpoint from {agent_dir}" in out
    assert "WARNING" not in out
    assert metrics["num_samples"] == 1
    assert np.isfinite(metrics["rte_median_all"])
    cfg = micro_config()
    # the geo checkpoint was saved at step 0's validation, before the
    # steps: the CLI chain read what the file holds
    saved = torch.load(os.path.join(geo_dir, "model"), weights_only=True)
    _assert_same_bits(checkpoint.restore_state_dict(geo_dir, cfg,
                                                    "multihead"),
                      saved["module"])
    assert saved["step"] == 0 and geo_state.step == 2
    assert agent_state.step > 0
