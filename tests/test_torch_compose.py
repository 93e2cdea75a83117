"""The port's coarse-to-fine composition vs the JAX package, on the CPU in
f32: the composition functions of ``env/environment.py``, the flagship
observation settings, the mask-pack compaction (kernel 11's plain version
against the Pallas kernel in interpret mode) with the ``"pack"``/``"mega"``
episode, and ``serve.composed_pipeline`` as a whole against the JAX
package's exported pipeline with the same weights through the bridge.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmr_agent_tpu.config import micro_config as jax_micro_config
from cmr_agent_tpu.config import tiny_config as jax_tiny_config
from cmr_agent_tpu.data import SyntheticDataset, collate
from cmr_agent_tpu.env import environment as jenv
from cmr_agent_tpu.env import run_episode as jax_run_episode
from cmr_agent_tpu.models import CMRAgent as JaxAgent
from cmr_agent_tpu.models import IterModel as JaxIterModel
from cmr_agent_tpu.models import MultiHeadModel as JaxMultiHead
from cmr_agent_tpu.ops.pallas_kernels import mask_compact_pack
from cmr_agent_tpu.train.export import (export_composed_pipeline,
                                        load_exported)
from cmr_agent_tpu.train.train_iter import iter_model_state as jax_iter_state
from cmr_agent_tpu_torch import serve
from cmr_agent_tpu_torch.config import micro_config, tiny_config
from cmr_agent_tpu_torch.env import environment as penv
from cmr_agent_tpu_torch.env.episode import run_episode
from cmr_agent_tpu_torch.models.agent import CMRAgent
from cmr_agent_tpu_torch.models.cost_volume import IterModel
from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
from cmr_agent_tpu_torch.ops import kernels
from cmr_agent_tpu_torch.train.convert import flax_to_state_dict
from cmr_agent_tpu_torch.train.train_iter import iter_model_state


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _yaw_pose(b, yaw, t):
    pose = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    pose[:, 0, 0] = pose[:, 2, 2] = np.cos(yaw)
    pose[:, 0, 2], pose[:, 2, 0] = np.sin(yaw), -np.sin(yaw)
    pose[:, :3, 3] = t
    return pose


def _scene(rng, b=2, n=1024, f=8, h=6, w=10, overlap_p=0.3):
    """A cloud in front of the camera with unit descriptors, as the geo
    head gives them."""
    K = np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1]], np.float32)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)

    return {
        "pc": (rng.normal(size=(b, n, 3)) * 2 + [0.5, 0, 6]).astype(
            np.float32),
        "K": np.tile(K, (b, 1, 1)),
        "pc_overlap_pred": rng.random((b, n)) < overlap_p,
        "pc_is_in_cam_scores": rng.random((b, n)).astype(np.float32),
        "pc_geo_feat": unit(rng.normal(size=(b, n, f))),
        "img_geo_feat": unit(rng.normal(size=(b, h, w, f))),
    }


# --------------------------------------------------------------------------
# composition functions
# --------------------------------------------------------------------------

def test_bearing_init_pose_matches_jax():
    """A pure yaw per sample; a sample without predicted overlap starts
    from the identity. atol 1e-6."""
    st = _scene(np.random.default_rng(1))
    # a sector to one side, so that the centroid's bearing is well away
    # from the cancellation of a cloud-wide random mask
    st["pc_overlap_pred"][0] = st["pc"][0, :, 0] > 1.5
    st["pc_overlap_pred"][1] = False
    want = np.asarray(jenv.bearing_init_pose(_j(st)))
    got = penv.bearing_init_pose(_t(st)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    assert abs(want[0, 0, 2]) > 1e-3                        # a real yaw
    np.testing.assert_allclose(got[1], np.eye(4), atol=1e-7)


def test_apply_coarse_pose_matches_jax():
    rng = np.random.default_rng(2)
    b = 2
    batch = {"pc": rng.normal(size=(b, 64, 3)).astype(np.float32),
             "node": rng.normal(size=(b, 8, 3)).astype(np.float32),
             "P": _yaw_pose(b, 0.4, [1.0, 0.0, -2.0]),
             "pt2node": rng.integers(0, 8, size=(b, 64)).astype(np.int32)}
    coarse = _yaw_pose(b, -0.7, [0.3, 0.0, 1.5])
    want = jenv.apply_coarse_pose(_j(batch), jnp.asarray(coarse))
    got = penv.apply_coarse_pose(_t(batch), torch.from_numpy(coarse))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)
    no_target = penv.apply_coarse_pose(
        {k: v for k, v in _t(batch).items() if k != "P"},
        torch.from_numpy(coarse))
    assert "P" not in no_target


def test_alignment_and_nn_alignment_stats_match_jax():
    """At a nonzero yaw. Sums of N cosines over N: atol 1e-6; the inlier
    statistics are counts over N, exact up to that division. 1024 points in
    chunks of 300 also covers the ragged last chunk."""
    st = _scene(np.random.default_rng(3))
    pose = _yaw_pose(2, 0.35, [0.4, 0.0, -0.5])
    want = jenv.alignment_stats(_j(st), jnp.asarray(pose), 6, 10)
    got = penv.alignment_stats(_t(st), torch.from_numpy(pose), 6, 10)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, err_msg=k)
    assert float(np.asarray(want["frac_valid"]).min()) > 0.05
    np.testing.assert_allclose(
        penv.alignment_score(_t(st), torch.from_numpy(pose), 6, 10).numpy(),
        np.asarray(want["sum_norm"]), atol=1e-6)
    want = jenv.nn_alignment_stats(_j(st), jnp.asarray(pose), 6, 10,
                                   radius_px=3.0, chunk=300)
    got = penv.nn_alignment_stats(_t(st), torch.from_numpy(pose), 6, 10,
                                  radius_px=3.0, chunk=300)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, err_msg=k)
    assert float(np.asarray(want["ir_norm"]).max()) > 0


def test_compose_disentangled_matches_jax():
    rng = np.random.default_rng(4)
    pc = (rng.normal(size=(2, 128, 3)) + [1.0, 0.2, 5.0]).astype(np.float32)
    final = _yaw_pose(2, 0.3, [0.1, 0.0, 0.4])
    coarse = _yaw_pose(2, -1.1, [2.0, 0.0, -1.0])
    want = jenv.compose_disentangled(jnp.asarray(final), jnp.asarray(coarse),
                                     jnp.asarray(pc))
    got = penv.compose_disentangled(torch.from_numpy(final),
                                    torch.from_numpy(coarse),
                                    torch.from_numpy(pc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# --------------------------------------------------------------------------
# the flagship observation settings
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pose_aware,bearing", [(True, False), (False, True),
                                                (True, True)])
def test_observation_settings_match_jax(pose_aware, bearing):
    """The 3-D observation with the moved cloud and the bearing channels,
    at a nonzero yaw: atol 1e-5 (2e-5 on the raster's means)."""
    st = _scene(np.random.default_rng(5))
    pose = _yaw_pose(2, 0.5, [0.3, 0.0, -0.4])
    w2, w3 = jenv.observation_from_pose(
        jenv.compact_observation_state(_j(st), 512), jnp.asarray(pose), 6, 10,
        pose_aware=pose_aware, bearing_channels=bearing)
    g2, g3 = penv.observation_from_pose(
        penv.compact_observation_state(_t(st), 512), torch.from_numpy(pose),
        6, 10, pose_aware=pose_aware, bearing_channels=bearing)
    assert g3.shape == (2, 1024, 7 if bearing else 5)
    np.testing.assert_allclose(g3.numpy(), np.asarray(w3), atol=1e-5)
    np.testing.assert_allclose(g2.numpy(), np.asarray(w2), atol=2e-5)


@pytest.mark.parametrize("aux", [False, True])
def test_agent_with_bearing_channels_matches_jax(aux):
    """The 7-channel point branch and the ``policy_aux_state`` head width
    through the bridge: logits and value atol 1e-4, as the 5-channel agent
    is held in tests/test_torch_geo.py."""
    over = dict(obs_bearing_channels=True, policy_aux_state=aux)
    jcfg, cfg = jax_micro_config(**over), micro_config(**over)
    rng = np.random.default_rng(6)
    h, w, f = jcfg.image_h, jcfg.image_w, jcfg.embed_dim
    o2 = rng.normal(size=(2, h, w, 2 * f)).astype(np.float32)
    o3 = rng.normal(size=(2, jcfg.num_pt, 7)).astype(np.float32)
    o3[..., 5:] = o3[:, :1, 5:]            # constant per sample, as served
    agent = JaxAgent(jcfg)
    av = _numpy_tree(agent.init({"params": jax.random.key(2)},
                                jnp.asarray(o2), jnp.asarray(o3),
                                train=False))
    want = agent.apply(av, jnp.asarray(o2), jnp.asarray(o3), train=False)
    pa = CMRAgent(cfg).eval()
    pa.load_state_dict(flax_to_state_dict(cfg, av, "agent"))
    assert pa.policy_r[0].in_features == 4 * f + (2 if aux else 0)
    with torch.no_grad():
        got = pa(torch.from_numpy(o2), torch.from_numpy(o3))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-4)


def test_policy_aux_state_needs_the_bearing_channels():
    with pytest.raises(ValueError, match="bearing"):
        CMRAgent(micro_config(policy_aux_state=True))


# --------------------------------------------------------------------------
# kernel 11's plain version, the pack compaction and the pack/mega episode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("p_keep,dtype", [(0.3, "float32"), (0.8, "float32"),
                                          (0.8, "bfloat16")])
def test_mask_compact_pack_plain_matches_pallas_interpret(p_keep, dtype):
    """count < k and count > k (the highest indices dropped), f32 and bf16
    features: rows are copied, so the outputs are equal bit for bit."""
    rng = np.random.default_rng(int(p_keep * 10))
    b, n, f, k, block = 2, 1024, 8, 512, 128
    mask = rng.random((b, n)) < p_keep
    counts = mask.sum(1)
    assert (counts < k).all() if p_keep < 0.5 else (counts > k).all()
    pcT = rng.normal(size=(b, 3, n)).astype(np.float32)
    feat = rng.normal(size=(b, n, f)).astype(np.float32)
    jfeat = jnp.asarray(feat).astype(dtype)
    want_f, want_p = mask_compact_pack(jnp.asarray(mask), jnp.asarray(pcT),
                                       jfeat, k, block=block, interpret=True)
    tfeat = torch.from_numpy(feat).to(getattr(torch, dtype))
    got_f, got_p = kernels.mask_compact_pack(torch.from_numpy(mask),
                                             torch.from_numpy(pcT), tfeat, k)
    assert got_f.dtype == tfeat.dtype and got_p.dtype == torch.float32
    np.testing.assert_array_equal(got_f.float().numpy(),
                                  np.asarray(want_f.astype(jnp.float32)))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    # first-index-first, and zero past the count
    for bb in range(b):
        kept = np.flatnonzero(mask[bb])[:k]
        np.testing.assert_array_equal(got_p[bb, :, :len(kept)].numpy(),
                                      pcT[bb][:, kept])
        assert not got_f[bb, len(kept):].any()


def test_mask_compact_pack_plain_takes_integer_masks():
    mask = torch.tensor([[0, 2, 0, 1, 1]], dtype=torch.int32)
    pcT = torch.arange(15, dtype=torch.float32).reshape(1, 3, 5)
    feat = torch.arange(10, dtype=torch.float32).reshape(1, 5, 2)
    got_f, got_p = kernels.mask_compact_pack_plain(mask, pcT, feat, 2)
    assert got_f.tolist() == [[[2.0, 3.0], [6.0, 7.0]]]
    assert got_p.tolist() == [[[1.0, 3.0], [6.0, 8.0], [11.0, 13.0]]]


def _pack_scene(rng, overlap_p=0.25):
    st = _scene(rng, b=2, n=2048, overlap_p=overlap_p)
    return st, _yaw_pose(2, 0.2, [0.5, 0.0, -0.3])


@pytest.mark.parametrize("overlap_p", [0.25, 0.6])
def test_pack_compaction_state_matches_jax(overlap_p):
    """``compact_observation_state(mode="pack")`` against the JAX one in
    interpret mode, with every overlap count under the budget of 1024 rows
    and with every count over it (rows dropped): every raster key equal."""
    k = 1024
    st, _ = _pack_scene(np.random.default_rng(30), overlap_p)
    counts = st["pc_overlap_pred"].sum(1)
    assert (counts < k).all() if overlap_p < 0.5 else (counts > k).all()
    want = jenv.compact_observation_state(_j(st), k, mode="pack",
                                          interpret=True)
    got = penv.compact_observation_state(_t(st), k, mode="pack")
    for key in ("raster_feat", "raster_pcT", "raster_pc", "raster_valid",
                "raster_dropped"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert got["raster_pcT"].is_contiguous()
    assert (got["raster_dropped"].numpy() == np.maximum(counts - k, 0)).all()
    with pytest.raises(ValueError, match="compaction mode"):
        penv.compact_observation_state(_t(st), k, mode="compact")


def test_mega_observation_on_the_packed_state_matches_jax():
    """One observation on the pack-compacted state against the JAX mega
    raster in interpret mode (atol 2e-5, as tests/test_environment.py holds
    that kernel to the composable raster)."""
    st, pose = _pack_scene(np.random.default_rng(31))
    jc = jenv.compact_observation_state(_j(st), 1024, mode="pack",
                                        interpret=True)
    w2, w3 = jenv.observation_from_pose(jc, jnp.asarray(pose), 6, 10,
                                        raster_mode="mega",
                                        raster_interpret=True)
    pc_ = penv.compact_observation_state(_t(st), 1024, mode="pack")
    g2, g3 = penv.observation_from_pose(pc_, torch.from_numpy(pose), 6, 10)
    np.testing.assert_allclose(g2.numpy(), np.asarray(w2), atol=2e-5)
    np.testing.assert_allclose(g3.numpy(), np.asarray(w3), atol=1e-6)


@pytest.fixture(scope="module")
def episode_case():
    """tiny config, raster_topk 1024 >= every overlap count, so the pack
    compaction and the JAX episode's ranked top-k (its CPU fallback) hold
    the same rows in another order."""
    jcfg = jax_tiny_config(raster_topk=1024, action_num=4)
    rng = np.random.default_rng(40)
    h, w, f, n = jcfg.image_h, jcfg.image_w, jcfg.embed_dim, jcfg.num_pt
    st = _scene(rng, b=2, n=n, f=f, h=h, w=w, overlap_p=0.3)
    assert st["pc_overlap_pred"].sum(1).max() <= 1024
    agent = JaxAgent(jcfg)
    av = _numpy_tree(agent.init({"params": jax.random.key(4)},
                                jnp.zeros((2, h, w, 2 * f)),
                                jnp.zeros((2, n, 5)), train=False))
    pose0 = _yaw_pose(2, 0.1, [0.2, 0.0, 0.1])
    return st, av, pose0


@pytest.mark.parametrize("mode", ["pack", "mega"])
def test_pack_and_mega_episode_match_jax(episode_case, mode):
    """The eval episode under ``raster_mode`` "pack"/"mega" against the JAX
    ``run_episode`` with the same setting: per-step actions where the top-2
    logit margin exceeds 1e-4, final poses atol 1e-4."""
    st, av, pose0 = episode_case
    over = dict(raster_topk=1024, action_num=4, raster_mode=mode)
    jcfg, cfg = jax_tiny_config(**over), tiny_config(**over)
    jagent = JaxAgent(jcfg)
    want_final, traj = jax_run_episode(
        lambda v, o2, o3: jagent.apply(v, o2, o3, train=False), av,
        dict(_j(st), pc_in_cam_space=jnp.asarray(st["pc"]),
             pc_mask=jnp.asarray(st["pc_overlap_pred"])),
        jnp.asarray(pose0), jnp.asarray(pose0), jcfg, deterministic=True,
        collect_trajectory=True, raster_topk=1024)
    agent = CMRAgent(cfg).eval()
    agent.load_state_dict(flax_to_state_dict(cfg, av, "agent"))
    before = kernels.mask_compact_pack.launches
    with torch.no_grad():
        final, steps, _ = run_episode(agent, _t(st), torch.from_numpy(pose0),
                                      cfg, raster_topk=1024)
    assert kernels.mask_compact_pack.launches == before  # CPU: plain version
    checked = 0
    for s, (r_logits, t_logits) in enumerate(steps):
        for logits, key in ((r_logits, "action_r"), (t_logits, "action_t")):
            top2 = torch.topk(logits, 2, dim=-1).values
            sure = (top2[..., 0] - top2[..., 1] > 1e-4).numpy()
            np.testing.assert_array_equal(
                logits.argmax(-1).numpy()[sure],
                np.asarray(traj[key][s])[sure])
            checked += int(sure.sum())
    assert checked > 0
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final),
                               atol=1e-4)


def test_training_episode_keeps_the_ranked_topk_under_pack():
    """``collect_trajectory`` episodes never take the pack compaction (it
    has no gradient and drops by index)."""
    cfg = tiny_config(raster_topk=256, action_num=1, raster_mode="pack")
    st = _t(_scene(np.random.default_rng(41), b=1, n=cfg.num_pt,
                   f=cfg.embed_dim, h=cfg.image_h, w=cfg.image_w,
                   overlap_p=0.5))
    st["pc_in_cam_space"], st["pc_mask"] = st["pc"], st["pc_overlap_pred"]
    agent = CMRAgent(cfg).eval()
    pose0 = torch.eye(4)[None]
    with torch.no_grad():
        _, _, traj = run_episode(agent, st, pose0, cfg, 256,
                                 pose_target=pose0, collect_trajectory=True)
        _, steps, _ = run_episode(agent, st, pose0, cfg, 256)
    want = penv.observation_from_pose(
        penv.compact_observation_state(st, 256, mode="topk"), pose0,
        cfg.image_h, cfg.image_w, raster_mode="flat")[0]
    assert torch.equal(traj["state_2d"][0], want)
    packed = penv.observation_from_pose(
        penv.compact_observation_state(st, 256, mode="pack"), pose0,
        cfg.image_h, cfg.image_w)[0]
    assert not torch.equal(packed, want)     # the two drop different rows


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

FLAGSHIP = dict(cost_volume_unmasked=True, pose_aware_observation=True,
                obs_bearing_channels=True, policy_aux_state=True,
                bearing_init=True)
INPUT_KEYS = ("img", "pc", "node", "pt2node", "K", "R_amplitude",
              "T_amplitude")


def _composed_case():
    """micro_config with the flagship's observation settings; one batch of
    two synthetic scenes; the three JAX modules' variables and the port's
    modules loaded from them through the bridge."""
    jcfg, cfg = jax_micro_config(**FLAGSHIP), micro_config(**FLAGSHIP)
    ds = SyntheticDataset(jcfg, length=2, seed=5)
    batch_np = collate([ds[0], ds[1]])
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    geo = JaxMultiHead(jcfg)
    gv = _numpy_tree(jax.jit(lambda r, b: geo.init(
        r, b, train=False, with_loss=False))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jb))
    gv_fresh = copy.deepcopy(gv)
    # the port's synthetic-weights recipe (serve.spread_random_weights_) on
    # the JAX variables. A fresh overlap head may call every point overlap,
    # and the bearing of an all-points sector is atan2 of two rounding
    # residues: sharpen the point head and centre it, so that about half
    # the cloud is predicted and no point sits within rounding of the 0.5
    # threshold
    gain = serve.OVERLAP_HEAD_GAIN
    logits = np.asarray(geo.apply(gv, jb, train=False, with_loss=False)
                        ["pc_overlap_logits"])
    head = gv["params"]["overlap_head"]["pc_head_1"]
    head["kernel"] = np.float32(gain) * head["kernel"]
    head["bias"] = np.float32(gain) * head["bias"] - np.array(
        [0.0, gain * np.median(logits[..., 1] - logits[..., 0])],
        np.float32)
    geo_out = geo.apply(gv, jb, train=False, with_loss=False)
    n_overlap = np.asarray(geo_out["pc_overlap_pred"]).sum(1)
    assert (n_overlap > 50).all() and (n_overlap < jcfg.num_pt - 50).all()
    st = jax_iter_state(geo_out, jb)
    iterm = JaxIterModel(jcfg)
    iv = _numpy_tree(jax.jit(lambda r, s: iterm.init(
        {"params": r}, s, train=False, with_loss=False))(
        jax.random.key(1), st))
    # a fresh tower scores every hypothesis alike to 7 digits; widen its
    # kernels so that the yaw nomination is a choice, not a tie
    iv_fresh = iv
    iv = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.float32(serve.TOWER_GAIN) * a
                         if path[-1].key == "kernel" else a), iv)
    h, w, f = jcfg.image_h, jcfg.image_w, jcfg.embed_dim
    agent = JaxAgent(jcfg)
    av = _numpy_tree(jax.jit(lambda r, o2, o3: agent.init(
        {"params": r}, o2, o3, train=False))(
        jax.random.key(2), jnp.zeros((2, h, w, 2 * f)),
        jnp.zeros((2, jcfg.num_pt, jcfg.obs3d_channels))))
    modules = []
    for cls, variables, which in ((MultiHeadModel, gv, "multihead"),
                                  (IterModel, iv, "itermodel"),
                                  (CMRAgent, av, "agent")):
        m = cls(cfg).eval()
        m.load_state_dict(flax_to_state_dict(cfg, variables, which))
        modules.append(m)
    return dict(jcfg=jcfg, cfg=cfg, batch_np=batch_np, jb=jb, gv=gv, iv=iv,
                av=av, modules=modules, gv_fresh=gv_fresh, iv_fresh=iv_fresh)


@pytest.fixture(scope="module")
def composed():
    return _composed_case()


def test_spread_random_weights_is_the_recipe_of_this_file(composed):
    """``serve.spread_random_weights_`` on the fresh weights gives the
    weights the JAX side of these tests runs on: tower and head kernels
    exactly, the head's shifted bias within 1e-3 (the median of the two
    packages' logits, times the gain of 100)."""
    cfg = composed["cfg"]
    geo, iterm = MultiHeadModel(cfg).eval(), IterModel(cfg).eval()
    geo.load_state_dict(flax_to_state_dict(cfg, composed["gv_fresh"],
                                           "multihead"))
    iterm.load_state_dict(flax_to_state_dict(cfg, composed["iv_fresh"],
                                             "itermodel"))
    serve.spread_random_weights_(geo, iterm, _t(composed["batch_np"]))
    for got, want in ((geo, composed["modules"][0]),
                      (iterm, composed["modules"][1])):
        want_sd = want.state_dict()
        for name, value in got.state_dict().items():
            shifted = name == "overlap_head.pc_overlap_head.2.bias"
            torch.testing.assert_close(value, want_sd[name], rtol=0,
                                       atol=1e-3 if shifted else 0,
                                       msg=lambda m, n=name: f"{n}: {m}")
    bias = geo.state_dict()["overlap_head.pc_overlap_head.2.bias"]
    fresh = flax_to_state_dict(cfg, composed["gv_fresh"], "multihead")[
        "overlap_head.pc_overlap_head.2.bias"]
    assert abs(bias[1] - 100.0 * fresh[1]) > 1e-2    # the shift is there


def test_iter_model_state_matches_jax(composed):
    jb, gv, jcfg = composed["jb"], composed["gv"], composed["jcfg"]
    want = jax_iter_state(JaxMultiHead(jcfg).apply(
        gv, jb, train=False, with_loss=False), jb)
    tb = _t(composed["batch_np"])
    with torch.no_grad():
        got = iter_model_state(composed["modules"][0](tb), tb)
    assert got.keys() == want.keys()
    for k in ("pc_i", "pc_geo_feat", "img_geo_feat", "pc_is_in_cam_scores",
              "img_overlap_pred", "matrix_accumulated", "label_R"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)
    serving = iter_model_state(composed["modules"][0](tb),
                               {k: tb[k] for k in INPUT_KEYS})
    assert "label_R" not in serving


PIPELINES = {
    "plain": dict(hypotheses=2),
    "beam_own": dict(hypotheses=3, iter_iters=2, iter_shrink=0.25,
                     hypo_score="combo", refine_rounds=1,
                     refine_beam=("combo", "mean_valid:2"),
                     beam_score="above50_norm", beam_frame="own"),
    "beam_shared": dict(hypotheses=3, iter_iters=2, iter_shrink=0.25,
                        hypo_score="combo", refine_rounds=1,
                        refine_beam=("combo", "mean_valid:2"),
                        beam_score="smooth_mean", beam_frame="shared"),
}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_composed_pipeline_matches_jax_export(composed, name):
    """``serve.composed_pipeline`` against the JAX package's exported
    pipeline (serialised, loaded and called) with the same weights:
    ``candidate_scores`` atol 1e-4; ``pose`` atol 1e-4 and ``score`` atol
    1e-4 on the samples whose candidate selection is clear of that
    tolerance (first and second score more than 1e-3 apart)."""
    opts = PIPELINES[name]
    jb = composed["jb"]
    blob = export_composed_pipeline(composed["jcfg"], composed["gv"],
                                    composed["iv"], composed["av"], jb,
                                    **opts)
    want = load_exported(blob).call({k: np.asarray(jb[k])
                                     for k in INPUT_KEYS})
    pipeline = serve.composed_pipeline(composed["cfg"], *composed["modules"],
                                       **opts)
    got = pipeline(_t({k: composed["batch_np"][k] for k in INPUT_KEYS}))
    w_scores = np.asarray(want["candidate_scores"])
    assert got["candidate_scores"].shape == w_scores.shape == (
        2, opts["hypotheses"])
    np.testing.assert_allclose(got["candidate_scores"].numpy(), w_scores,
                               atol=1e-4)
    top2 = np.sort(w_scores, axis=1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 1e-3
    assert sure.any()
    np.testing.assert_allclose(got["pose"].numpy()[sure],
                               np.asarray(want["pose"])[sure], atol=1e-4)
    np.testing.assert_allclose(got["score"].numpy()[sure],
                               np.asarray(want["score"])[sure], atol=1e-4)
    R = got["pose"].numpy()[:, :3, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.tile(np.eye(3), (2, 1, 1)), atol=1e-4)


def test_composed_pipeline_refuses_an_unknown_beam_frame(composed):
    with pytest.raises(ValueError, match="beam_frame"):
        serve.composed_pipeline(composed["cfg"], *composed["modules"],
                                beam_frame="other")


def test_build_composed_workload_on_cpu_runs_the_pipeline():
    """The E7 options at micro size, on the CPU."""
    cfg = micro_config(**FLAGSHIP)
    batch, modules, pipeline = serve.build_composed_workload(
        cfg, 2, device="cpu", hypotheses=4, iter_iters=2, refine_rounds=1,
        refine_beam=("combo", "mean_valid", "ir_smooth"),
        beam_score="above50_norm", hypo_score="combo")
    assert set(batch) == set(INPUT_KEYS)
    assert not any(m.training for m in modules)
    out = pipeline(batch)
    assert out["pose"].shape == (2, 4, 4)
    assert out["candidate_scores"].shape == (2, 4)
    assert all(torch.isfinite(v).all() for v in out.values())


def test_build_composed_workload_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_composed_workload(micro_config(), 1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
