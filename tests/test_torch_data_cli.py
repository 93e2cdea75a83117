"""The port's CLIs on KITTI and nuScenes trees against the JAX package's
CLIs on the same trees, on the CPU.

The trees are written from a seed in the reference's on-disk formats
(``chip_smoke.write_kitti_tree`` / ``write_nuscenes_tree``) at the micro
size of ``tests/test_torch_eval_cli.py``: the KITTI or nuScenes
configuration with 2048 points, 160 nodes, 32 proxies and a 64 x 128 crop
(the weights fix every width and depth, no point or pixel count), swapped
in for each CLI's ``build_config``. The JAX CLIs restore and run as
``test_torch_eval_cli.py`` has them (a concrete-``step`` restore, the
Pallas segment softmax in interpret mode).

* ``cli.test_geo`` and ``cli.test_agent`` at the committed trained weights:
  the same JSON, within that file's tolerances;
* ``cli.train_geo``: the two packages start from different random weights,
  so what is held is what the CLI feeds its steps: every train and
  validation batch equal, array for array, in the same order, and the
  same steps and checkpoint names. The JAX CLI's steps are recorded, not
  run (its train state is a stand-in), which also spares their compile.
"""

import os
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
import test_torch_eval_cli as evalcli
from cmr_agent_tpu.cli import test_agent as jax_test_agent
from cmr_agent_tpu.cli import test_geo as jax_test_geo
from cmr_agent_tpu.cli import train_geo as jax_train_geo
from cmr_agent_tpu.config import kitti_config as jax_kitti_config
from cmr_agent_tpu.config import nuscenes_config as jax_nuscenes_config
from cmr_agent_tpu_torch.cli import test_agent, test_geo, train_geo
from cmr_agent_tpu_torch.config import kitti_config, nuscenes_config

MICRO = dict(evalcli.MICRO, train_batch_size=2, val_batch_size=2)
CONFIGS = {"kitti": (kitti_config, jax_kitti_config),
           "nuscenes": (nuscenes_config, jax_nuscenes_config)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    k, n = str(root / "kitti"), str(root / "nuscenes")
    chip_smoke.write_kitti_tree(k, seqs=("00", "09", "10"), frames=2,
                                h=141, w=301, n_pts=5000)
    chip_smoke.write_nuscenes_tree(n, count=4, n_pts=3000, h=64, w=128)
    return {"kitti": k, "nuscenes": n}


def _micro_config(args, which):
    """The micro configuration of ``--dataset`` at ``--data-root``, with
    the ``--logdir`` / ``--ckpt-dir`` given."""
    over = {k: getattr(args, k) for k in ("logdir", "ckpt_dir")
            if getattr(args, k, None)}
    return CONFIGS[args.dataset][which](args.data_root, **MICRO, **over)


@pytest.fixture
def clis(micro_clis_base, monkeypatch):
    """Every CLI's ``build_config`` gives :func:`_micro_config`."""
    for port, jax in ((test_agent, jax_test_agent), (test_geo, jax_test_geo),
                      (train_geo, jax_train_geo)):
        for mod, which in ((port, 0), (jax, 1)):
            monkeypatch.setattr(mod, "build_config",
                                lambda args, w=which: _micro_config(args, w))


@pytest.fixture
def micro_clis_base(monkeypatch):
    """The JAX CLIs as ``test_torch_eval_cli.py``'s ``micro_clis`` has
    them, from the repository's root."""
    monkeypatch.chdir(evalcli.REPO)
    monkeypatch.setattr(evalcli.jax_point_encoder,
                        "batched_segment_softmax_attend",
                        evalcli._fused_softmax)
    for mod in (jax_test_agent, jax_test_geo):
        monkeypatch.setattr(mod, "load_geo_variables",
                            evalcli._jax_load_geo_variables)
    for mod in (jax_test_agent, evalcli.jax_train_agent, evalcli.jax_train):
        monkeypatch.setattr(mod, "restore_model_variables",
                            evalcli._jax_restore)


def _argv(name, root, *extra):
    return ["--dataset", name, "--data-root", root, "--num-workers", "0",
            *extra]


@pytest.mark.parametrize("name", ["kitti", "nuscenes"])
def test_test_geo_cli_on_a_tree_matches_jax(clis, trees, name):
    argv = _argv(name, trees[name], "--geo-ckpt", "runs_r4/geo_pi",
                 "--iter-ckpt", "checkpoint/iter_kitti/epoch-1-step-10000",
                 "--unmasked-warp", "--max-batches", "2")
    want = jax_test_geo.main(argv)
    got = test_geo.main(argv + ["--device", "cpu"])
    assert list(got) == list(want) and got["num_samples"] == 2
    assert got["matching_inlier_ratio"] == pytest.approx(
        want["matching_inlier_ratio"], abs=1e-6)
    for k in ("cost_volume_rte_mean", "cost_volume_rre_mean"):
        assert got[k] == pytest.approx(want[k], abs=evalcli.RTE_ATOL), k


@pytest.mark.parametrize("name", ["kitti", "nuscenes"])
def test_test_agent_cli_on_a_tree_matches_jax(clis, trees, tmp_path, name):
    """One episode a scene at the trained geo model and agent, the
    ``.mat`` and the JSON within ``test_torch_eval_cli.py``'s tolerances."""
    argv = _argv(name, trees[name], "--geo-ckpt", "runs_r4/geo_pi",
                 "--agent-ckpt", "runs_r4/agent_45", "--pose-aware",
                 "--aux-head", "--bearing-init", "--eval-batch-size", "2",
                 "--max-batches", "1")
    m, _, got, _ = evalcli._both_test_agent(argv, tmp_path)
    assert m["num_samples"] == 2


def _recorder(calls, kind, result):
    def make(*a, **k):
        def step(state, batch, *rest):
            calls.append((kind, {key: np.asarray(v)
                                 for key, v in batch.items()}))
            return result(state)
        return step
    return make


@pytest.mark.parametrize("name", ["kitti", "nuscenes"])
def test_train_geo_cli_on_a_tree_feeds_what_jax_feeds(clis, trees, tmp_path,
                                                      monkeypatch, name):
    """Both CLIs for 3 steps (an epoch is 2 batches of 2): the same train
    and validation batches in the same order, the same checkpoint names."""
    argv = _argv(name, trees[name], "--steps", "3")
    jax_calls, port_calls, saved = [], [], {"jax": [], "port": []}
    state = types.SimpleNamespace(step=jnp.zeros((), jnp.int32))
    metrics = {"loss": jnp.asarray(1.0, jnp.float32)}
    monkeypatch.setattr(jax_train_geo, "create_geo_state",
                        lambda *a, **k: state)
    monkeypatch.setattr(jax_train_geo, "make_geo_train_step", _recorder(
        jax_calls, "train", lambda s: (s, metrics)))
    monkeypatch.setattr(jax_train_geo, "make_geo_eval_step", _recorder(
        jax_calls, "val", lambda s: metrics))
    monkeypatch.setattr(jax_train_geo, "save_train_checkpoint",
                        lambda path, s: saved["jax"].append(
                            os.path.basename(path)))
    jax_train_geo.main(argv + ["--ckpt-dir", str(tmp_path / "jax"),
                               "--logdir", str(tmp_path / "jlog")])

    for fname, kind in (("make_geo_train_step", "train"),
                        ("make_geo_eval_step", "val")):
        make = getattr(train_geo, fname)

        def wrapped(cfg, _make=make, _kind=kind):
            fn = _make(cfg)

            def step(state, batch, *rest):
                port_calls.append((_kind, {k: v.numpy()
                                           for k, v in batch.items()}))
                return fn(state, batch, *rest)
            return step
        monkeypatch.setattr(train_geo, fname, wrapped)
    real_save = train_geo.save_train_checkpoint
    monkeypatch.setattr(train_geo, "save_train_checkpoint",
                        lambda path, s: (saved["port"].append(
                            os.path.basename(path)), real_save(path, s)))
    out = train_geo.main(argv + ["--device", "cpu", "--ckpt-dir",
                                 str(tmp_path / "port"), "--logdir",
                                 str(tmp_path / "plog")])
    assert out.step == 3
    kinds = [k for k, _ in port_calls]
    assert kinds == [k for k, _ in jax_calls]
    assert kinds.count("train") == 3 and "val" in kinds
    for (_, got), (_, want) in zip(port_calls, jax_calls):
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert np.array_equal(got[key], want[key]), key
    assert saved["port"] == saved["jax"] == ["epoch-0-step-0"]
