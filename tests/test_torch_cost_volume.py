"""The port's cost volume (``models/cost_volume.py``) and the plain version
of its shared-data segment sum vs the JAX package, on the CPU in f32.

The JAX ``IterModel`` runs two ways: its accelerator path in Pallas
interpret mode (``interpret=True``: top-K compaction + the shared one-hot
kernel), which is the path the port follows, and its default CPU path (the
``lax.map`` chunked scatter over every masked point), which equals it where
the compaction drops nothing. Weights go through the bridge.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmr_agent_tpu.config import kitti_config as jax_kitti_config
from cmr_agent_tpu.config import tiny_config as jax_tiny_config
from cmr_agent_tpu.models import IterModel as JaxIterModel
from cmr_agent_tpu.models.cost_volume import (
    decode_topk_yaw_poses as jax_decode_topk, sample_pose_grid as jax_grid)
from cmr_agent_tpu.ops.pallas_kernels import segment_sum_fused_shared
from cmr_agent_tpu_torch.config import kitti_config, tiny_config
from cmr_agent_tpu_torch.models.cost_volume import (IterModel,
                                                    decode_topk_yaw_poses,
                                                    sample_pose_grid)
from cmr_agent_tpu_torch.ops import kernels
from cmr_agent_tpu_torch.train.convert import flax_to_state_dict

REPO = Path(__file__).resolve().parents[1]
# logits: the tolerance tests/test_models.py holds the two JAX paths to (the
# per-pixel sums run in another order)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_state(state_np):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in state_np.items()}


# --------------------------------------------------------------------------
# kernel 7's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,tile", [(256, 128), (200, 128), (77, 512)])
def test_segment_sum_shared_plain_matches_pallas_interpret(n, tile):
    """Sums of ~n/m rows per pixel in another order: rtol 1e-5, atol 1e-5.
    Hypothesis 1 has every row routed out; ``n`` need not be a multiple of
    the Pallas tile."""
    rng = np.random.default_rng(n)
    b, p, f, m = 2, 4, 6, 19
    data = rng.normal(size=(b, n, f)).astype(np.float32)
    idx = rng.integers(0, m + 3, size=(b, p, n)).astype(np.int32)
    idx[:, 1] = m
    want = np.asarray(segment_sum_fused_shared(
        jnp.asarray(data), jnp.asarray(idx), m, tile, True))
    got = kernels.segment_sum_shared(torch.from_numpy(data),
                                     torch.from_numpy(idx), m)
    assert got.shape == (b, p, m, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not got[:, 1].any()


def test_segment_sum_shared_routes_negative_ids_out():
    data = torch.ones(1, 3, 2)
    idx = torch.tensor([[[0, -1, 5], [2, 2, 2]]], dtype=torch.int32)
    got = kernels.segment_sum_shared_plain(data, idx, 3)
    want = torch.zeros(1, 2, 3, 2)
    want[0, 0, 0] = 1.0
    want[0, 1, 2] = 3.0
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# pose grid and top-k decode
# --------------------------------------------------------------------------

def test_sample_pose_grid_matches_jax():
    r = np.array([np.pi, 0.3], np.float32)
    t = np.array([10.0, 2.5], np.float32)
    want = jax_grid(jnp.asarray(r), jnp.asarray(t), 5)
    got = sample_pose_grid(torch.from_numpy(r), torch.from_numpy(t), 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    with pytest.raises(ValueError, match="odd"):
        sample_pose_grid(torch.from_numpy(r), torch.from_numpy(t), 4)


@pytest.mark.parametrize("nlabel,k", [(5, 1), (5, 3), (5, 5), (3, 5), (3, 6),
                                      (9, 13)])
def test_decode_topk_yaw_poses_matches_jax(nlabel, k):
    """k <= nlabel (distinct yaw bins) and k > nlabel (rank-2 translation
    nominees). Poses are built from exact grid values: atol 1e-6."""
    rng = np.random.default_rng(100 * nlabel + k)
    logits = (3.0 * rng.normal(size=(3, nlabel ** 3))).astype(np.float32)
    r = np.array([np.pi, 1.0, 0.2], np.float32)
    t = np.array([10.0, 5.0, 1.0], np.float32)
    want = jax_decode_topk(jnp.asarray(logits), jnp.asarray(r),
                           jnp.asarray(t), nlabel, k)
    got = decode_topk_yaw_poses(torch.from_numpy(logits), torch.from_numpy(r),
                                torch.from_numpy(t), nlabel, k)
    assert got.shape == (3, k, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_decode_topk_breaks_ties_to_the_lower_bin_and_caps_k():
    """Constant logits tie every yaw bin: candidates come in bin order, as
    ``lax.top_k`` nominates them."""
    logits = np.zeros((1, 27), np.float32)
    r, t = np.array([1.0], np.float32), np.array([2.0], np.float32)
    want = jax_decode_topk(jnp.asarray(logits), jnp.asarray(r),
                           jnp.asarray(t), 3, 5)
    got = decode_topk_yaw_poses(torch.from_numpy(logits), torch.from_numpy(r),
                                torch.from_numpy(t), 3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    with pytest.raises(ValueError, match="exceeds"):
        decode_topk_yaw_poses(torch.from_numpy(logits), torch.from_numpy(r),
                              torch.from_numpy(t), 3, 7)


# --------------------------------------------------------------------------
# IterModel
# --------------------------------------------------------------------------

def _synthetic_state(cfg, rng, b=1, with_labels=False, empty_primary=False):
    """A seeded state: a cloud in front of the camera, random features."""
    n, h, w, f = cfg.num_pt, cfg.image_h, cfg.image_w, cfg.embed_dim
    K = np.array([[float(w), 0, w / 2], [0, float(w), h / 2], [0, 0, 1]],
                 np.float32)
    overlap = rng.integers(0, 2, size=(b, n)).astype(bool)
    standby = overlap & (rng.uniform(size=(b, n)) > 0.5)
    if empty_primary:
        overlap[0] = False
        standby[0, ::3] = True
    state = {
        "pc_i": (rng.normal(size=(b, n, 3)) + [0, 0, 4]).astype(np.float32),
        "K": np.broadcast_to(K, (b, 3, 3)).copy(),
        "pc_geo_feat": rng.normal(size=(b, n, f)).astype(np.float32),
        "img_geo_feat": rng.normal(size=(b, h, w, f)).astype(np.float32),
        "pc_overlap_pred": overlap,
        "pc_overlap_pred_standby": standby,
        "pc_is_in_cam_scores": rng.uniform(size=(b, n)).astype(np.float32),
        "img_overlap_pred": rng.uniform(size=(b, h, w)).astype(np.float32),
        "matrix_accumulated": np.broadcast_to(
            np.eye(4, dtype=np.float32), (b, 4, 4)).copy(),
        "R_amplitude": np.full((b,), np.pi, np.float32),
        "T_amplitude": np.full((b,), 5.0, np.float32),
    }
    if with_labels:
        for key in ("label_R", "label_T_x", "label_T_z"):
            lab = np.zeros((b, cfg.nlabel), np.float32)
            lab[np.arange(b), rng.integers(0, cfg.nlabel, size=b)] = 1.0
            state[key] = lab
    return state


def _jax_state(state_np):
    return {k: jnp.asarray(v) for k, v in state_np.items()}


@pytest.fixture(scope="module")
def iter_case():
    """tiny width, 256 points, nlabel 3, batch 2 with decode labels; sample
    0's p > 0.5 mask is empty, so it falls back to the standby mask."""
    over = dict(num_pt=256, cropped_img_h=64, cropped_img_w=128, nlabel=3,
                cost_volume_eval_chunk=9)
    jcfg, cfg = jax_tiny_config(**over), tiny_config(**over)
    state = _synthetic_state(jcfg, np.random.default_rng(7), b=2,
                             with_labels=True, empty_primary=True)
    ivars = _numpy_tree(JaxIterModel(jcfg).init(
        {"params": jax.random.key(3)}, _jax_state(state), train=False,
        with_loss=False))
    # the fresh init gives logits that differ in their 7th digit only (ten
    # layers of LeakyReLU(0.01) at fan-in scale): widen the kernels, and
    # give biases and running statistics values, so that the hypotheses get
    # distinct scores and eval BatchNorm is exercised
    rng = np.random.default_rng(8)

    def widen(path, a):
        name = path[-1].key
        if name == "kernel":
            return (3.0 * a).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.2 * rng.normal(size=a.shape)).astype(np.float32)
        return (a + 0.3 * rng.uniform(size=a.shape)).astype(np.float32)

    ivars = jax.tree_util.tree_map_with_path(widen, ivars)
    return jcfg, cfg, state, ivars


def _port_model(cfg, ivars, **kw):
    model = IterModel(cfg, **kw).eval()
    model.load_state_dict(flax_to_state_dict(cfg, ivars, "itermodel"))
    return model


def _assert_outputs_match(got, want, check_choice=True):
    np.testing.assert_allclose(got["cost_volume_logits"].numpy(),
                               np.asarray(want["cost_volume_logits"]),
                               **LOGIT_TOL)
    np.testing.assert_array_equal(got["warp_dropped_points"].numpy(),
                                  np.asarray(want["warp_dropped_points"]))
    if not check_choice:
        return
    # the decode is an argmax per axis: hold it where JAX's own marginals
    # separate the first from the second bin by more than the tolerance
    logits = np.asarray(want["cost_volume_logits"], np.float64)
    nl = round(logits.shape[1] ** (1 / 3))
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob = (prob / prob.sum(1, keepdims=True)).reshape(-1, nl, nl, nl)
    margins = []
    for axes in ((2, 3), (1, 3), (1, 2)):
        top2 = np.sort(prob.sum(axis=axes), axis=1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
    sure = np.min(margins, axis=0) > 1e-4
    assert sure.any()
    for key, atol in (("matrix_i", 1e-6), ("matrix_accumulated", 1e-5),
                      ("pc_i", 1e-5), ("pred_ry", 1e-6), ("pred_tx", 1e-6),
                      ("pred_tz", 1e-6)):
        np.testing.assert_allclose(got[key].numpy()[sure],
                                   np.asarray(want[key])[sure], atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("unmasked", [False, True])
def test_itermodel_matches_jax_accelerator_path(iter_case, unmasked):
    """Against ``IterModel(cfg, warp_topk=N, interpret=True)``: the same
    compaction and the Pallas shared sum in interpret mode. Logits rtol
    2e-4 atol 2e-5; the loss (a log-softmax of them) atol 1e-4."""
    jcfg, cfg, state, ivars = iter_case
    over = {**_overrides(cfg), "cost_volume_unmasked": unmasked}
    jcfg, cfg = jax_tiny_config(**over), tiny_config(**over)
    want = JaxIterModel(jcfg, warp_topk=jcfg.num_pt, interpret=True).apply(
        ivars, _jax_state(state), train=False, with_loss=True)
    with torch.no_grad():
        got = _port_model(cfg, ivars, warp_topk=cfg.num_pt)(
            _torch_state(state), with_loss=True)
    _assert_outputs_match(got, want)
    np.testing.assert_array_equal(got["cost_volume_label"].numpy(),
                                  np.asarray(want["cost_volume_label"]))
    np.testing.assert_allclose(got["cost_volume_loss"].item(),
                               float(want["cost_volume_loss"]), atol=1e-4)
    assert np.asarray(want["warp_dropped_points"]).tolist() == [0, 0]


def _overrides(cfg):
    return dict(num_pt=cfg.num_pt, cropped_img_h=cfg.cropped_img_h,
                cropped_img_w=cfg.cropped_img_w, nlabel=cfg.nlabel,
                cost_volume_eval_chunk=cfg.cost_volume_eval_chunk)


def test_itermodel_matches_jax_default_cpu_path(iter_case):
    """Against the default ``IterModel(cfg)`` on the CPU (the chunked
    scatter over every masked point): equal where nothing is dropped."""
    jcfg, cfg, state, ivars = iter_case
    want = JaxIterModel(jcfg).apply(ivars, _jax_state(state), train=False,
                                    with_loss=False)
    with torch.no_grad():
        got = _port_model(cfg, ivars)(_torch_state(state), with_loss=False)
    _assert_outputs_match(got, want)
    assert "cost_volume_loss" not in got


def test_itermodel_capped_compaction_reports_the_dropped_points(iter_case):
    """``warp_topk`` below the masked count: both sides drop the same
    lowest-score points (scores are distinct) and report how many."""
    jcfg, cfg, state, ivars = iter_case
    n_masked = int(state["pc_overlap_pred"][1].sum())
    n_standby = int(state["pc_overlap_pred_standby"][0].sum())
    cap = min(n_masked, n_standby) - 10
    want = JaxIterModel(jcfg, warp_topk=cap, interpret=True).apply(
        ivars, _jax_state(state), train=False, with_loss=False)
    with torch.no_grad():
        got = _port_model(cfg, ivars, warp_topk=cap)(_torch_state(state),
                                                     with_loss=False)
    _assert_outputs_match(got, want, check_choice=False)
    assert got["warp_dropped_points"].tolist() == [n_standby - cap,
                                                   n_masked - cap]


def test_itermodel_chunked_eval_equals_single_shot(iter_case):
    """Eval BatchNorm reads running stats, so scoring 27 hypotheses in
    chunks of 9, of 27 (one shot) or with chunking off gives the same
    logits (conv batches of another size: atol 1e-6)."""
    _, cfg, state, ivars = iter_case
    outs = []
    for chunk in (9, 27, 0):
        c = tiny_config(**{**_overrides(cfg), "cost_volume_eval_chunk": chunk})
        with torch.no_grad():
            outs.append(_port_model(c, ivars)(_torch_state(state),
                                              with_loss=False))
    for other in outs[1:]:
        np.testing.assert_allclose(other["cost_volume_logits"].numpy(),
                                   outs[0]["cost_volume_logits"].numpy(),
                                   atol=1e-6)
        assert torch.equal(other["matrix_i"], outs[0]["matrix_i"])


def test_itermodel_bridge_is_total_and_keeps_the_volume_channel_order():
    """Every leaf of the JAX tower lands in the port's state_dict, and the
    first conv's input axis crosses unchanged ([img_geo | warped |
    occupancy | img_overlap] = 2F + 2 channels)."""
    jcfg, cfg = jax_tiny_config(nlabel=3), tiny_config(nlabel=3)
    f = cfg.embed_dim
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: JaxIterModel(jcfg).init(
        {"params": jax.random.key(0)},
        _jax_state(_synthetic_state(jcfg, rng)), train=False,
        with_loss=False))
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), dict(shapes))
    sd = flax_to_state_dict(cfg, variables, "itermodel")
    assert len(sd) == len(jax.tree_util.tree_leaves(variables))
    w0 = variables["params"]["cv_conv0_0"]["kernel"]          # [3,3,2F+2,F]
    assert w0.shape == (3, 3, 2 * f + 2, f)
    got = sd["cost_volume_convs.0.weight"].numpy()            # [F,2F+2,3,3]
    np.testing.assert_array_equal(got, np.transpose(w0, (3, 2, 0, 1)))
    with pytest.raises(ValueError, match="which"):
        flax_to_state_dict(cfg, variables, "cost_volume")


def test_itermodel_trained_checkpoint_matches_jax():
    """The committed stage-B cost-volume checkpoint through the bridge: the
    KITTI pixel grid and width, ``nlabel=3`` (the tower does not depend on
    it), 4096 points, one seeded synthetic state. Trained weights and
    running statistics give logits of a few units: rtol 2e-4, atol 1e-4."""
    from cmr_agent_tpu.train.checkpoint import (model_tree_path,
                                                restore_checkpoint)
    over = dict(nlabel=3, num_pt=4096)
    jcfg, cfg = jax_kitti_config(**over), kitti_config(**over)
    state = _synthetic_state(jcfg, np.random.default_rng(21))
    jstate = _jax_state(state)
    model = JaxIterModel(jcfg)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0)}, jstate, train=False, with_loss=False))
    template = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), dict(shapes))
    # restore_model_variables gives the saved ``step`` leaf no sharding, and
    # the one on file names the device that wrote it; a concrete leaf in the
    # template restores on this host
    template["step"] = jnp.zeros((), jnp.int32)
    restored = restore_checkpoint(model_tree_path(
        str(REPO / "checkpoint" / "iter_kitti" / "epoch-1-step-10000")),
        template=template)
    assert int(restored.pop("step")) == 10001
    ivars = _numpy_tree(restored)
    assert np.abs(ivars["params"]["cv_conv0_0"]["kernel"]).max() > 0
    want = model.apply(ivars, jstate, train=False, with_loss=False)
    with torch.no_grad():
        got = _port_model(cfg, ivars)(_torch_state(state), with_loss=False)
    w = np.asarray(want["cost_volume_logits"])
    assert w.shape == (1, 27) and np.ptp(w) > 1e-3
    np.testing.assert_allclose(got["cost_volume_logits"].numpy(), w,
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_array_equal(got["warp_dropped_points"].numpy(), [0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
