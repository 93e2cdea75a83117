"""The port's checkpoint module and the committed weight exports vs the JAX
package, on the CPU in f32.

* Each export in ``cmr_agent_tpu_torch/weights/`` equals a fresh JAX
  restore of its Orbax tree, leaf for leaf and bit for bit, and its sha256
  is the manifest's.
* The exports loaded through ``train/checkpoint.py`` and the bridge give
  the JAX modules' outputs at the restored weights: the geo forward
  (``geo_pi``, ``geo_45``), one agent episode (``agent_45``, the flagship
  observation flags) and the ``IterModel`` logits.
* A port geo train state saved and restored continues bit for bit; a
  model-only restore moves the schedule's position and keeps fresh moments.
* ``registration_metrics``, ``matching_centers`` and
  ``matching_inlier_ratio`` against the JAX package's.
* The flagship evaluation's test split (E7 of ``runs_r5/README.md``: 64
  structured scenes at full KITTI width), built by each package's CLI
  ``build_dataset`` with its native host ops, array for array.

The micro size with trained weights: the weights fix every width and depth
but no point or pixel count, so the KITTI configuration is cut to 2048
points, 160 nodes, 32 proxies and a 64 x 128 crop (a 16 x 32 feature map).
On the JAX side the geo model's segment softmax runs the Pallas
kernel in interpret mode, as on the TPU that trained these weights: its XLA
fallback stabilises each segment by the segment's own max, the kernel by
the channel's global max, and at trained weights whole node -> proxy
segments sit so far below the global max that their exponentials underflow
to 0 in the kernel (the port's kernel and plain version do as the Pallas
kernel does).
"""

import argparse
import hashlib
import importlib.util
import os
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cmr_agent_tpu.cli import common as jax_common
from cmr_agent_tpu.config import kitti_config as jax_kitti_config
from cmr_agent_tpu.data import SyntheticDataset, collate
from cmr_agent_tpu.env import bearing_init_pose as jax_bearing_init
from cmr_agent_tpu.env import run_episode as jax_run_episode
from cmr_agent_tpu.models import CMRAgent as JaxAgent
from cmr_agent_tpu.models import IterModel as JaxIterModel
from cmr_agent_tpu.models import MultiHeadModel as JaxMultiHead
from cmr_agent_tpu.models import multi_head as jax_multi_head
from cmr_agent_tpu.models import point_encoder as jax_point_encoder
from cmr_agent_tpu.ops import to_disentangled as jax_to_disentangled
from cmr_agent_tpu.ops.pallas_kernels import segment_softmax_attend_fused
from cmr_agent_tpu.train import metrics as jax_metrics
from cmr_agent_tpu.train.train_iter import iter_model_state as jax_iter_state
import chip_smoke
from cmr_agent_tpu_torch import serve
from cmr_agent_tpu_torch.cli import common
from cmr_agent_tpu_torch.config import kitti_config, micro_config
from cmr_agent_tpu_torch.env.environment import bearing_init_pose
from cmr_agent_tpu_torch.env.episode import run_episode
from cmr_agent_tpu_torch.models import multi_head
from cmr_agent_tpu_torch.models.agent import CMRAgent
from cmr_agent_tpu_torch.models.cost_volume import IterModel
from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
from cmr_agent_tpu_torch.train import checkpoint, metrics
from cmr_agent_tpu_torch.train.train_geo import (create_geo_state,
                                                 make_geo_train_step)
from cmr_agent_tpu_torch.train.train_iter import iter_model_state

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4          # the geo and agent outputs (tests/test_torch_geo.py)
MARGIN = 1e-4        # an action is compared where its top-2 margin exceeds
E7_FLAGS = dict(cost_volume_unmasked=True, pose_aware_observation=True,
                obs_bearing_channels=True, policy_aux_state=True,
                bearing_init=True)
MICRO = dict(num_pt=2048, num_node=160, num_proxy=32, cropped_img_h=64,
             cropped_img_w=128, **E7_FLAGS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", REPO / "tests" / "export_torch_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, p) if isinstance(v, dict) else {p: v})
    return out


def _restore(tree):
    """The ``params`` and ``batch_stats`` of the export of ``tree``."""
    out = checkpoint.restore_model_variables(str(REPO / tree))
    return {k: out[k] for k in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def pallas_softmax():
    """The JAX geo model's segment softmax through the Pallas kernel in
    interpret mode (its TPU route), for the module's tests."""
    def fused(attn, values, idx, m, use_pallas=None):
        return segment_softmax_attend_fused(attn, values,
                                            idx.astype(jnp.int32), m,
                                            interpret=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_point_encoder, "batched_segment_softmax_attend", fused)
        yield


@pytest.fixture(scope="module")
def scenes():
    """Two structured test scenes at the micro size, as numpy."""
    jcfg = jax_kitti_config(**MICRO)
    from cmr_agent_tpu.native import get_fast_host_ops
    fps_fn, nn_fn = get_fast_host_ops()
    ds = SyntheticDataset(jcfg, length=2, seed=2, fps_fn=fps_fn, nn_fn=nn_fn,
                          scene="structured")
    return collate([ds[0], ds[1]])


@pytest.mark.parametrize("stem", sorted(checkpoint.manifest()))
def test_export_equals_a_fresh_orbax_restore(stem):
    entry = checkpoint.manifest()[stem]
    path = checkpoint.WEIGHTS_DIR / entry["file"]
    assert checkpoint.file_sha256(path) == entry["sha256"]
    assert os.path.getsize(path) == entry["bytes"]
    want = _exporter().restore_tree(entry["orbax"])
    got = _flatten(checkpoint.restore_model_variables(str(REPO / entry["orbax"])))
    assert sorted(got) == sorted(want) and len(got) == entry["leaves"]
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k
    if "step" in want:
        assert int(got["step"]) == 10001
    # the export's file, the tree and its model subtree name one export
    assert checkpoint.export_path(str(path)) == path
    assert checkpoint.export_path(str(REPO / entry["orbax"])) == path
    keys = checkpoint.saved_tree_keys(str(REPO / entry["orbax"]))
    assert {"params", "batch_stats"} <= keys


def test_every_e7_tree_has_an_export():
    assert sorted(e["orbax"] for e in checkpoint.manifest().values()) == [
        "checkpoint/iter_kitti/epoch-1-step-10000", "runs_r4/agent_45",
        "runs_r4/geo_45", "runs_r4/geo_pi"]
    assert checkpoint.model_tree_path(
        str(REPO / "checkpoint/iter_kitti/epoch-1-step-10000")).endswith(
        os.path.join("epoch-1-step-10000", "model"))


def test_a_tree_without_an_export_raises_naming_the_exporter(tmp_path):
    tree = "checkpoint/iter_kitti/epoch-0-step-10500"
    assert (REPO / tree).is_dir()
    with pytest.raises(FileNotFoundError, match="export_torch_weights"):
        checkpoint.restore_model_variables(str(REPO / tree))
    with pytest.raises(FileNotFoundError, match="export_torch_weights"):
        checkpoint.restore_model_variables(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_model_variables(str(tmp_path / "none.npz"))


@pytest.mark.parametrize("tree", ["runs_r4/geo_pi", "runs_r4/geo_45"])
def test_geo_forward_at_the_exported_weights_matches_jax(tree, scenes,
                                                         pallas_softmax):
    jcfg, cfg = jax_kitti_config(**MICRO), kitti_config(**MICRO)
    gv = _restore(tree)
    keys = ("img", "pc", "node", "pt2node", "K")
    want = JaxMultiHead(jcfg).apply(
        gv, {k: jnp.asarray(scenes[k]) for k in keys}, train=False,
        with_loss=False)
    model = checkpoint.load_module_variables(MultiHeadModel(cfg), cfg, gv,
                                             "multihead").eval()
    with torch.no_grad():
        got = model({k: torch.from_numpy(scenes[k]) for k in keys})
    for key in ("pc_geo_feat", "img_geo_feat", "pc_overlap_logits",
                "img_overlap_logits", "pc_is_in_cam_scores"):
        w = np.asarray(want[key])
        assert np.ptp(w) > 1e-2, key          # trained outputs, not a constant
        np.testing.assert_allclose(got[key].numpy(), w, atol=ATOL,
                                   err_msg=key)


def test_agent_episode_at_the_exported_weights_matches_jax(scenes,
                                                           pallas_softmax):
    """One deterministic episode of ``agent_45`` under the flagship flags
    from the bearing yaw, both packages on the JAX geo model's state: the
    agent's logits on a seeded observation, each step's actions where the
    port's logits have a top-2 margin above ``MARGIN``, the final pose."""
    jcfg, cfg = jax_kitti_config(**MICRO), kitti_config(**MICRO)
    av = _restore("runs_r4/agent_45")
    gv = _restore("runs_r4/geo_45")
    jb = {k: jnp.asarray(v) for k, v in scenes.items()}
    out = JaxMultiHead(jcfg).apply(gv, jb, train=False, with_loss=False)
    state = {"pc": out["pc"], "K": jb["K"],
             "pc_overlap_pred": out["pc_overlap_pred"],
             "pc_geo_feat": out["pc_geo_feat"],
             "img_geo_feat": out["img_geo_feat"],
             "pc_in_cam_space": jb["pc_in_cam_space"],
             "pc_mask": jb["pc_mask"], "P": jb["P"]}
    assert 0 < float(np.mean(np.asarray(state["pc_overlap_pred"]))) < 1
    agent = JaxAgent(jcfg)
    pose_src = jax_bearing_init(state)
    pose_tgt = jax_to_disentangled(jb["P"], state["pc"])
    want_final, traj = jax_run_episode(
        lambda v, o2, o3: agent.apply(v, o2, o3, train=False), av, state,
        pose_src, pose_tgt, jcfg, deterministic=True,
        collect_trajectory=True, raster_topk=jcfg.episode_raster_topk())

    pa = checkpoint.load_module_variables(CMRAgent(cfg), cfg, av,
                                          "agent").eval()
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    with torch.no_grad():
        final, steps, _ = run_episode(pa, tstate,
                                      bearing_init_pose(tstate), cfg,
                                      cfg.episode_raster_topk())
    checked = 0
    for s, (r_logits, t_logits) in enumerate(steps):
        for logits, key in ((r_logits, "action_r"), (t_logits, "action_t")):
            top2 = torch.topk(logits, 2, dim=-1).values
            sure = (top2[..., 0] - top2[..., 1] > MARGIN).numpy()
            np.testing.assert_array_equal(
                logits.argmax(dim=-1).numpy()[sure],
                np.asarray(traj[key][s])[sure])
            checked += int(sure.sum())
    assert checked > 0
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final),
                               atol=1e-4)

    rng = np.random.default_rng(8)
    o2 = rng.normal(size=(2, cfg.image_h, cfg.image_w,
                          2 * cfg.embed_dim)).astype(np.float32)
    o3 = np.concatenate([rng.normal(size=(2, 300, 3)) * 5,
                         rng.integers(0, 2, size=(2, 300, 2)),
                         rng.normal(size=(2, 300, 2))], -1).astype(np.float32)
    want = agent.apply(av, jnp.asarray(o2), jnp.asarray(o3), train=False)
    with torch.no_grad():
        got = pa(torch.from_numpy(o2), torch.from_numpy(o3))
    for g, w in zip(got, want):
        assert np.ptp(np.asarray(w)) > 1e-2
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_itermodel_at_the_exported_weights_matches_jax(scenes,
                                                       pallas_softmax):
    """The cost volume of the exported stage-B tree on the geo model's
    state: logits within the tolerance of
    ``tests/test_torch_cost_volume.py`` (rtol 2e-4, atol 1e-4) and the same
    decoded pose."""
    jcfg, cfg = jax_kitti_config(**MICRO), kitti_config(**MICRO)
    iv = _restore("checkpoint/iter_kitti/epoch-1-step-10000")
    gv = _restore("runs_r4/geo_pi")
    jb = {k: jnp.asarray(v) for k, v in scenes.items()}
    geo_out = JaxMultiHead(jcfg).apply(gv, jb, train=False, with_loss=False)
    jstate = jax_iter_state(geo_out, jb)
    want = JaxIterModel(jcfg).apply(iv, jstate, train=False, with_loss=False)
    tstate = iter_model_state(
        {k: torch.from_numpy(np.array(v)) for k, v in geo_out.items()},
        {k: torch.from_numpy(np.asarray(v)) for k, v in scenes.items()})
    model = checkpoint.load_module_variables(IterModel(cfg), cfg, iv,
                                             "itermodel").eval()
    with torch.no_grad():
        got = model(tstate, with_loss=False)
    w = np.asarray(want["cost_volume_logits"])
    assert w.shape == (2, 729) and np.ptp(w) > 1e-2
    np.testing.assert_allclose(got["cost_volume_logits"].numpy(), w,
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got["matrix_accumulated"].numpy(),
                               np.asarray(want["matrix_accumulated"]),
                               atol=1e-5)


def _train_steps(state, batch, seeds):
    step = make_geo_train_step(micro_config())
    return [float(step(state, batch, torch.Generator().manual_seed(s))["loss"])
            for s in seeds]


def test_train_checkpoint_resumes_bit_for_bit(tmp_path):
    """4 steps uninterrupted against 2 steps, a save, a fresh state with
    other weights, the restore and 2 more: equal losses, parameters,
    BatchNorm statistics and Adam moments, bit for bit."""
    cfg = micro_config()
    batch = serve.synthetic_batch(cfg, 2, "cpu", keys=serve.TRAIN_KEYS)
    ref = create_geo_state(cfg, device="cpu", seed=0)
    ref_losses = _train_steps(ref, batch, range(4))

    state = create_geo_state(cfg, device="cpu", seed=0)
    _train_steps(state, batch, range(2))
    path = str(tmp_path / "train_ckpt")
    checkpoint.save_train_checkpoint(path, state)
    assert checkpoint.saved_tree_keys(path) == {"module", "step"}
    del state
    resumed = create_geo_state(cfg, device="cpu", seed=99)
    resumed, opt_restored = checkpoint.restore_train_checkpoint(path, resumed)
    assert opt_restored and resumed.step == 2
    assert _train_steps(resumed, batch, range(2, 4)) == ref_losses[2:]
    for (k, a), (_, b) in zip(ref.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), k
    for a, b in zip(ref.optimizer.inner.state.values(),
                    resumed.optimizer.inner.state.values()):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_model_only_restore_fast_forwards_the_schedule(tmp_path):
    cfg = micro_config(lr_scheduler="ExponentialLR")
    batch = serve.synthetic_batch(cfg, 2, "cpu", keys=serve.TRAIN_KEYS)
    state = create_geo_state(cfg, device="cpu", seed=0, steps_per_epoch=1)
    _train_steps(state, batch, range(2))
    path = str(tmp_path / "ckpt")
    checkpoint.save_train_checkpoint(path, state)
    os.remove(os.path.join(path, "opt"))
    fresh = create_geo_state(cfg, device="cpu", seed=5, steps_per_epoch=1)
    fresh, opt_restored = checkpoint.restore_train_checkpoint(path, fresh)
    assert not opt_restored
    assert fresh.step == 2 and not fresh.optimizer.inner.state
    assert fresh.optimizer.schedule(fresh.step) == pytest.approx(
        cfg.lr * cfg.scheduler_gamma ** 2)
    for (k, a), (_, b) in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), k
    _train_steps(fresh, batch, [7])
    assert fresh.step == 3
    assert all(int(s["step"]) == 1
               for s in fresh.optimizer.inner.state.values())


@pytest.mark.parametrize("case", ["mixed", "none_recalled", "empty"])
def test_registration_metrics_match_jax(case):
    rng = np.random.default_rng(3)
    rte = rng.uniform(0, 9, 64).astype(np.float32)
    rre = rng.uniform(0, 20, 64).astype(np.float32)
    if case == "none_recalled":
        rte = rte + 5.0
    elif case == "empty":
        rte, rre = rte[:0], rre[:0]
    got = metrics.registration_metrics(rte, rre)
    want = jax_metrics.registration_metrics(rte, rre)
    assert list(got) == list(want)
    for k in want:
        assert (np.isnan(got[k]) and np.isnan(want[k])) or got[k] == want[k], k
    if case == "mixed":
        assert 0 < got["registration_recall"] < 1


def test_metric_logger_keeps_history_and_reads_tensors_late(tmp_path):
    log = metrics.MetricLogger(str(tmp_path))
    log.log("a", 1.5, 0)
    log.log_dict({"b": torch.tensor(2.0)}, 1, prefix="p/")
    log.log_dict_lazy({"c": torch.tensor([1.0, 2.0, 3.0])}, 10,
                      steps_axis=True)
    log.log_dict_lazy({"d": torch.tensor(4.0, dtype=torch.bfloat16)}, 20)
    assert "c" not in log.history
    log.close()
    assert log.history == {"a": [(0, 1.5)], "p/b": [(1, 2.0)],
                           "c": [(10, 1.0), (11, 2.0), (12, 3.0)],
                           "d": [(20, 4.0)]}


def test_matching_matches_jax():
    """Feature-NN matching on seeded unit features, with a duplicated pixel
    feature (an exact tie: both take the first index) and points whose
    nearest pixel is their own projection."""
    rng = np.random.default_rng(4)
    h, w, f, n = 6, 10, 8, 300
    img = rng.normal(size=(h, w, f)).astype(np.float32)
    img[3, 7] = img[1, 2]                                      # a tie
    xy = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)]).astype(
        np.float32)
    pc = rng.normal(size=(n, f)).astype(np.float32)
    own = rng.random(n) < 0.5
    pc[own] = img[xy[1, own].astype(int), xy[0, own].astype(int)]
    pc[:5] = img[1, 2]                       # nearest: (2, 1) before (7, 3)
    mask = rng.random(n) < 0.8
    want_xy, want_in = jax_multi_head.matching_centers(
        jnp.asarray(pc), jnp.asarray(img), jnp.asarray(mask),
        jnp.asarray(xy), w)
    got_xy, got_in = multi_head.matching_centers(
        torch.from_numpy(pc), torch.from_numpy(img), torch.from_numpy(mask),
        torch.from_numpy(xy), w, chunk=64)
    np.testing.assert_array_equal(got_xy.numpy(), np.asarray(want_xy))
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    assert (got_xy[:, :5].numpy() == [[2.0], [1.0]]).all()
    want_ir = jax_multi_head.matching_inlier_ratio(
        jnp.asarray(pc), jnp.asarray(img), jnp.asarray(mask),
        jnp.asarray(xy), w, h)
    got_ir = multi_head.matching_inlier_ratio(
        torch.from_numpy(pc), torch.from_numpy(img), torch.from_numpy(mask),
        torch.from_numpy(xy), w, h)
    assert float(got_ir) == pytest.approx(float(want_ir), abs=1e-7)
    assert 0.3 < float(got_ir) < 1.0


def _e7_args():
    return argparse.Namespace(
        dataset="synthetic", tiny=False, synthetic_length=64, val_length=0,
        synthetic_scene="structured", data_root="")


def test_e7_test_split_equals_jax():
    """The 64 scenes of the flagship evaluation, built by each package's
    ``build_dataset`` with its native host ops, array for array."""
    args = _e7_args()
    got = common.build_dataset(kitti_config(), args, "test")
    want = jax_common.build_dataset(jax_kitti_config(), args, "test")
    assert len(got) == len(want) == 64
    digest = hashlib.sha256()
    for i in range(64):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        for k in sorted(w):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), \
                (i, k)
            digest.update(k.encode() + np.ascontiguousarray(w[k]).tobytes())
    # the digest the card's evaluation phase holds its own split to
    assert digest.hexdigest() == chip_smoke.E7_SPLIT_SHA256
