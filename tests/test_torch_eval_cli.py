"""The port's evaluation entry points vs the JAX package's, on the CPU.

* ``data/loader.py``: the same batches in the same order as the JAX
  package's ``DataLoader`` (synchronous and threads, shuffle on and off,
  across ``set_epoch``); the process pool as the synchronous loader.
* ``cli/common.py``: the settings the port refuses raise (the flagship
  evaluation's test split is held in ``tests/test_torch_checkpoint.py``).
* ``cli.test_agent`` and ``cli.test_geo`` end to end with the trained
  weights, both packages' ``main`` with the same flags (``--device cpu`` for
  the port): every per-sample and per-candidate entry of ``--save-mat``
  within the stated tolerances, the selections equal, the same JSON. For
  ``cli.test_agent`` the flagship's flags and three other paths: one
  episode, a refine round re-decoded by the cost volume (``--refine-iter``)
  and the shared-frame beam (``--beam-frame shared``).

The CLIs run at a micro size that the weights allow (they fix every width
and depth, no point or pixel count): the KITTI configuration with 2048
points, 160 nodes, 32 proxies and a 64 x 128 crop, swapped in for the CLIs'
``build_config``; K = 3 hypotheses, a 2-member beam, one refine round, two
scenes. The JAX CLIs restore the Orbax trees with a concrete ``step`` leaf
(``restore_model_variables`` cannot restore the saved ``step`` on a host
other than the TPU that wrote it), and their geo model's segment softmax
runs the Pallas kernel in interpret mode, as on the TPU (see
``tests/test_torch_checkpoint.py``).
"""

import argparse
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.io as scio
import torch

from cmr_agent_tpu.cli import common as jax_common
from cmr_agent_tpu.cli import test_agent as jax_test_agent
from cmr_agent_tpu.cli import test_geo as jax_test_geo
from cmr_agent_tpu.cli import train_agent as jax_train_agent
from cmr_agent_tpu.config import kitti_config as jax_kitti_config
from cmr_agent_tpu.data import DataLoader as JaxDataLoader
from cmr_agent_tpu.models import point_encoder as jax_point_encoder
from cmr_agent_tpu.ops.pallas_kernels import segment_softmax_attend_fused
from cmr_agent_tpu import train as jax_train
from cmr_agent_tpu.train.checkpoint import (model_tree_path,
                                            restore_checkpoint,
                                            saved_tree_keys)
from cmr_agent_tpu_torch.cli import common
from cmr_agent_tpu_torch.cli import test_agent, test_geo
from cmr_agent_tpu_torch.config import kitti_config, micro_config
from cmr_agent_tpu_torch.data import SyntheticDataset
from cmr_agent_tpu_torch.data.loader import DataLoader
from cmr_agent_tpu_torch.models.agent import CMRAgent

REPO = Path(__file__).resolve().parents[1]
MICRO = dict(num_pt=2048, num_node=160, num_proxy=32, cropped_img_h=64,
             cropped_img_w=128)
# per-sample and per-candidate tolerances of the .mat comparison
RTE_ATOL, RRE_ATOL, STAT_ATOL = 1e-3, 1e-3, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Toy:
    """A map-style dataset whose samples name their index and epoch."""

    def __init__(self, n):
        self.n, self.epoch = n, 0

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __getitem__(self, i):
        rng = np.random.default_rng((i, self.epoch))
        return {"x": rng.normal(size=(3, 2)).astype(np.float32),
                "i": np.int64(i), "epoch": np.int64(self.epoch)}


def _batches(loader, epochs=(0, 1, 2)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out.append(list(loader))
    return out


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for ge, we in zip(got, want):
        assert len(ge) == len(we)
        for g, w in zip(ge, we):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_matches_jax(workers, shuffle, drop_last):
    kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=workers,
              seed=7, prefetch=2)
    got = _batches(DataLoader(_Toy(11), 3, **kw))
    want = _batches(JaxDataLoader(_Toy(11), 3, **kw))
    _assert_same_batches(got, want)
    assert len(got[0]) == (3 if drop_last else 4)
    if shuffle:   # each epoch draws its own order
        assert not np.array_equal(got[0][0]["i"], got[1][0]["i"])


def test_process_loader_matches_the_synchronous_loader():
    ds = SyntheticDataset(micro_config(), length=4, seed=3)
    kw = dict(shuffle=True, seed=1)
    procs = DataLoader(ds, 2, num_workers=2, use_processes=True, **kw)
    try:
        got = _batches(procs, epochs=(0, 1))
    finally:
        procs.close()
    _assert_same_batches(got, _batches(DataLoader(ds, 2, num_workers=0, **kw),
                                       epochs=(0, 1)))


def _jax_restore(path, template):
    """The JAX CLIs' restore with a concrete ``step`` leaf."""
    mp = model_tree_path(path)
    tpl = {k: v for k, v in template.items() if k != "step"}
    if "step" in saved_tree_keys(mp):
        tpl["step"] = jnp.zeros((), jnp.int32)
    out = restore_checkpoint(mp, template=tpl)
    return {k: out[k] for k in template if k != "step"}


def _fused_softmax(attn, values, idx, m, use_pallas=None):
    return segment_softmax_attend_fused(attn, values, idx.astype(jnp.int32),
                                        m, interpret=True)


_XLA_SOFTMAX = jax_point_encoder.batched_segment_softmax_attend
_JAX_LOAD_GEO = jax_train_agent.load_geo_variables


def _jax_load_geo_variables(cfg, args, example):
    """The JAX CLIs' geo loading, its ``init`` traced on the XLA softmax:
    the init only shapes the template the restore fills, and traced on the
    Pallas kernel in interpret mode it compiles for over a minute."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_point_encoder, "batched_segment_softmax_attend",
                   _XLA_SOFTMAX)
        return _JAX_LOAD_GEO(cfg, args, example)


@pytest.fixture
def micro_clis(monkeypatch):
    """Both packages' eval CLIs at the micro size, the JAX ones restoring
    on this host and through the Pallas softmax."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(jax_point_encoder, "batched_segment_softmax_attend",
                        _fused_softmax)
    for mod in (jax_test_agent, jax_test_geo):
        monkeypatch.setattr(mod, "load_geo_variables",
                            _jax_load_geo_variables)
    for mod in (jax_test_agent, jax_train_agent, jax_train):
        monkeypatch.setattr(mod, "restore_model_variables", _jax_restore)
    for mod in (jax_test_agent, jax_test_geo):
        monkeypatch.setattr(mod, "build_config",
                            lambda args: jax_kitti_config(**MICRO))
    for mod in (test_agent, test_geo):
        monkeypatch.setattr(mod, "build_config",
                            lambda args: kitti_config(**MICRO))


E7_ARGV = ("--dataset synthetic --synthetic-scene structured "
           "--synthetic-length 2 "
           "--iter-ckpt checkpoint/iter_kitti/epoch-1-step-10000 "
           "--geo-ckpt runs_r4/geo_pi --fine-geo-ckpt runs_r4/geo_45 "
           "--agent-ckpt runs_r4/agent_45 --unmasked-warp --pose-aware "
           "--aux-head --bearing-init --hypo-score combo --refine-rounds 1 "
           "--eval-batch-size 1 --iter-hypotheses 3 "
           "--refine-beam combo,mean_valid:2 --beam-score above50_norm")


def _margin_ok(scores, tol):
    """Rows whose best score leads the runner-up by more than ``tol``."""
    top = np.sort(scores, axis=1)
    return top[:, -1] - top[:, -2] > tol


def _both_test_agent(argv, tmp_path):
    """Both packages' ``cli.test_agent.main`` on ``argv`` with
    ``--save-mat``: ``(port dict, JAX dict, port .mat, JAX .mat)``. Every
    per-sample and per-candidate entry of the two ``.mat`` files agrees
    within the tolerances, and so do the two dicts (recalls and counts
    exactly, errors within ``RTE_ATOL``), but for the times."""
    want_m = jax_test_agent.main(argv + ["--save-mat",
                                         str(tmp_path / "jax.mat")])
    got_m = test_agent.main(argv + ["--device", "cpu", "--save-mat",
                                    str(tmp_path / "port.mat")])
    want = scio.loadmat(tmp_path / "jax.mat")
    got = scio.loadmat(tmp_path / "port.mat")
    keys = sorted(k for k in want if not k.startswith("__"))
    assert keys == sorted(k for k in got if not k.startswith("__"))
    for k in keys:
        if k == "Time":
            continue
        atol = (RTE_ATOL if k.endswith("RTE") else
                RRE_ATOL if k.endswith("RRE") else STAT_ATOL)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)
    assert list(got_m) == list(want_m)
    for k, v in want_m.items():
        if "time" in k:
            continue
        recall = k.startswith("rr_") or k == "registration_recall"
        if isinstance(v, float) and not recall:
            assert got_m[k] == pytest.approx(v, abs=RTE_ATOL, nan_ok=True), k
        else:
            assert got_m[k] == v, k
    return got_m, want_m, got, want


def test_test_agent_cli_matches_jax(micro_clis, tmp_path):
    got_m, want_m, got, want = _both_test_agent(E7_ARGV.split(), tmp_path)
    assert got_m["num_samples"] == want_m["num_samples"] == 2
    assert want["hypo_RTE"].shape == (2, 3) and want["beam_RTE"].shape == (2, 2)
    for k in ("registration_recall", "rr_any_hypothesis", "rr_beam_any",
              "rr_pre_refine", "rr_selected", "rte_median_all",
              "rre_median_all", "coarse_rte_mean", "coarse_rre_mean"):
        assert k in got_m, k
    # the selections: the hypothesis vote by combo, the beam's re-vote by
    # above50_norm, and every statistic's what-if vote, where the margin
    # exceeds the tolerance
    for k in want:
        if k.startswith(("hypo_", "beam_")) and k[5:] not in ("RTE", "RRE"):
            sure = _margin_ok(want[k], STAT_ATOL)
            np.testing.assert_array_equal(got[k].argmax(1)[sure],
                                          want[k].argmax(1)[sure])
    assert _margin_ok(want["hypo_combo"], STAT_ATOL).all()


def test_test_geo_cli_matches_jax(micro_clis):
    argv = ("--dataset synthetic --synthetic-scene structured "
            "--synthetic-length 2 --geo-ckpt runs_r4/geo_pi "
            "--iter-ckpt checkpoint/iter_kitti/epoch-1-step-10000 "
            "--unmasked-warp").split()
    want = jax_test_geo.main(argv)
    got = test_geo.main(argv + ["--device", "cpu"])
    assert list(got) == list(want) and got["num_samples"] == 2
    assert got["matching_inlier_ratio"] == pytest.approx(
        want["matching_inlier_ratio"], abs=1e-6)
    assert want["matching_inlier_ratio"] > 0
    for k in ("cost_volume_rte_mean", "cost_volume_rre_mean"):
        assert got[k] == pytest.approx(want[k], abs=RTE_ATOL), k


@pytest.mark.parametrize("extra, error", [
    ("--device cuda", RuntimeError),            # no card on this host
    ("--dataset kitti", NotImplementedError),   # no dataset reader yet
    ("--dataset nuscenes", NotImplementedError),
    ("--obs3d-compact", None),                  # accepted: runs
    ("--geo-ckpt checkpoint/iter_kitti/epoch-0-step-10500", FileNotFoundError),
    ("--geo-ckpt geo_feat.pth", NotImplementedError),
])
def test_cli_refusals(micro_clis, monkeypatch, extra, error):
    """Each refusal raises; ``--obs3d-compact`` (``obs3d_source=
    "compact"``) runs, its agent observing the 1024 compacted rows."""
    argv = ["--device", "cpu", "--dataset", "synthetic",
            "--synthetic-length", "1"] + extra.split()
    if error is None:
        monkeypatch.setattr(test_agent, "build_config", lambda args:
                            kitti_config(raster_topk=1024, **MICRO))
        rows = []
        forward = CMRAgent.forward
        monkeypatch.setattr(CMRAgent, "forward", lambda self, s2, s3: (
            rows.append(s3.shape[1]), forward(self, s2, s3))[1])
        m = test_agent.main(argv)
        assert rows and set(rows) == {1024}, rows
        assert np.isfinite(m["rte_median_all"]), m
        return
    with pytest.raises(error):
        test_agent.main(argv)


def test_raster_int8_flag_keeps_the_jax_meaning():
    """``--raster-int8`` is ``store_true`` in both packages: it cannot turn
    the ``Config`` default off."""
    for pkg, cfg in ((common, kitti_config()),
                     (jax_common, jax_kitti_config())):
        p = pkg.add_common_args(argparse.ArgumentParser())
        for argv in ([], ["--raster-int8"]):
            assert pkg.apply_obs_overrides(cfg, p.parse_args(argv)
                                           ).raster_int8 is True


@pytest.mark.parametrize("extra", [
    "",                                                  # one episode
    "--refine-rounds 1 --iter-ckpt checkpoint/iter_kitti/epoch-1-step-10000 "
    "--unmasked-warp --refine-iter",                     # coarse-to-fine
    "--refine-rounds 1 --iter-ckpt checkpoint/iter_kitti/epoch-1-step-10000 "
    "--unmasked-warp --iter-hypotheses 3 --eval-batch-size 2 "
    "--refine-beam combo,ir_mean:2 --beam-frame shared",
])
def test_test_agent_cli_paths_run(micro_clis, tmp_path, extra):
    """The CLI's other paths (the single-hypothesis episode, a refine
    round re-decoded by the cost volume, the shared-frame beam) against
    the JAX CLI on the same flags, as the flagship's flags are held
    above."""
    argv = ("--dataset synthetic --synthetic-scene structured "
            "--synthetic-length 2 --geo-ckpt runs_r4/geo_pi "
            "--agent-ckpt runs_r4/agent_45 --pose-aware --aux-head "
            "--bearing-init " + extra).split()
    m, _, got, _ = _both_test_agent(argv, tmp_path)
    assert m["num_samples"] == 2
    assert ("coarse_rte_mean" in m) == ("--iter-ckpt" in extra)
    assert ("rr_beam_any" in m) == ("--refine-beam" in extra)
    assert ("rr_pre_refine" in m) == ("--refine-rounds" in extra)
    assert ("beam_RTE" in got) == ("--refine-beam" in extra)
