"""The port's serving slice (geo forward + 10-step episode) vs the JAX
package's ``run_episode`` on ``tiny_config(raster_topk=1024)`` in f32.

``raster_topk=1024`` (< ``num_pt`` = 2048) makes both sides compact the
observation set and take the raster path of the serving workload. On the
CPU the JAX episode rasters through its composable path, which
``tests/test_environment.py`` holds to the mega kernel at atol 2e-5; the
port runs its raster kernel's plain version. The JAX episode runs with
``collect_trajectory=True`` to expose its per-step actions; on the CPU that
takes the same observation path as its eval call.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmr_agent_tpu.config import tiny_config as jax_tiny_config
from cmr_agent_tpu.data import SyntheticDataset, collate
from cmr_agent_tpu.env import init_poses as jax_init_poses
from cmr_agent_tpu.env import run_episode as jax_run_episode
from cmr_agent_tpu.models import CMRAgent as JaxAgent
from cmr_agent_tpu.models import MultiHeadModel as JaxMultiHead
from cmr_agent_tpu.ops import to_disentangled as jax_to_disentangled
from cmr_agent_tpu_torch import serve
from cmr_agent_tpu_torch.config import tiny_config
from cmr_agent_tpu_torch.models.agent import CMRAgent
from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
from cmr_agent_tpu_torch.train.convert import flax_to_state_dict

MARGIN = 1e-4
KEYS = ("img", "pc", "node", "pt2node", "K", "P", "pc_in_cam_space",
        "pc_mask")


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def episodes():
    jcfg = jax_tiny_config(raster_topk=1024)
    cfg = tiny_config(raster_topk=1024)
    assert cfg.episode_raster_topk() == 1024
    ds = SyntheticDataset(jcfg, length=2, seed=11)
    batch_np = {k: v for k, v in collate([ds[0], ds[1]]).items() if k in KEYS}
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}

    model, agent = JaxMultiHead(jcfg), JaxAgent(jcfg)
    gv = _numpy_tree(model.init({"params": jax.random.key(0),
                                 "dropout": jax.random.key(1)}, jb,
                                train=False, with_loss=False))
    h, w, f = jcfg.image_h, jcfg.image_w, jcfg.embed_dim
    av = _numpy_tree(agent.init({"params": jax.random.key(2)},
                                jnp.zeros((2, h, w, 2 * f)),
                                jnp.zeros((2, jcfg.num_pt, 5)), train=False))
    out = model.apply(gv, jb, train=False, with_loss=False)
    state = {"pc": out["pc"], "K": jb["K"],
             "pc_overlap_pred": out["pc_overlap_pred"],
             "pc_geo_feat": out["pc_geo_feat"],
             "img_geo_feat": out["img_geo_feat"],
             "pc_in_cam_space": jb["pc_in_cam_space"],
             "pc_mask": jb["pc_mask"], "P": jb["P"]}
    pose_src, pose_tgt = jax_init_poses(state)
    pose_tgt = jax_to_disentangled(pose_tgt, state["pc"])
    want_final, traj = jax_run_episode(
        lambda v, o2, o3: agent.apply(v, o2, o3, train=False), av, state,
        pose_src, pose_tgt, jcfg, deterministic=True,
        collect_trajectory=True, raster_topk=jcfg.episode_raster_topk())

    pm, pa = MultiHeadModel(cfg).eval(), CMRAgent(cfg).eval()
    pm.load_state_dict(flax_to_state_dict(cfg, gv, "multihead"))
    pa.load_state_dict(flax_to_state_dict(cfg, av, "agent"))
    tb = {k: torch.from_numpy(batch_np[k]) for k in serve.BATCH_KEYS}
    got = serve.serve_episode(pm, pa, cfg, tb)
    return dict(cfg=cfg, want_final=np.asarray(want_final),
                want_target=np.asarray(pose_tgt), traj=traj, got=got)


def test_per_step_actions_match_jax(episodes):
    traj, steps = episodes["traj"], episodes["got"]["steps"]
    assert len(steps) == episodes["cfg"].action_num
    checked = 0
    for s, (r_logits, t_logits) in enumerate(steps):
        for logits, key in ((r_logits, "action_r"), (t_logits, "action_t")):
            top2 = torch.topk(logits, 2, dim=-1).values
            sure = (top2[..., 0] - top2[..., 1] > MARGIN).numpy()
            got = logits.argmax(dim=-1).numpy()
            want = np.asarray(traj[key][s])
            np.testing.assert_array_equal(got[sure], want[sure])
            checked += int(sure.sum())
    assert checked > 0


def test_final_poses_match_jax(episodes):
    got = episodes["got"]
    np.testing.assert_allclose(got["final_pose"].numpy(),
                               episodes["want_final"], atol=1e-4)
    np.testing.assert_allclose(got["pose_target"].numpy(),
                               episodes["want_target"], atol=1e-5)


def test_build_workload_defaults_to_cuda():
    """Without ``device=`` the workload asks for the card; on a host
    without CUDA it raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_workload(tiny_config(), batch_size=1)


@pytest.mark.parametrize("setting", [
    dict(is_6_dof=True), dict(raster_mode="pack"),
    dict(raster_mode="compact"), dict(obs3d_source="compact"),
    dict(pose_aware_observation=True), dict(obs_bearing_channels=True),
    dict(policy_aux_state=True), dict(bearing_init=True),
    dict(fused_stacks="all"), dict(fused_stacks="agent"),
    dict(fused_stacks="1")])
def test_config_refuses_settings_the_port_does_not_serve(setting,
                                                         monkeypatch):
    """A JAX serving setting the port has no path for fails at config time
    instead of running the megatopk 4-DoF episode in its place; a setting
    it serves is accepted and reaches the episode: "pack" one mask-pack
    launch, "compact" one compacting raster per step and no pack, fused
    stacks 4 channel-major chains per step (and, under "all", the geo
    model's 12 row-major chains), ``is_6_dof`` 3 + 3 action logits a step,
    ``obs3d_source="compact"`` a 3-D observation of ``raster_topk`` rows."""
    refused = {"fused_stacks": ValueError}
    (name, value), = setting.items()
    if name in refused and value not in ("all", "agent"):
        with pytest.raises(refused[name]):
            tiny_config(**setting)
        return
    if name == "policy_aux_state":       # reads the bearing channels
        setting = dict(setting, obs_bearing_channels=True)
    cfg = tiny_config(raster_topk=1024, action_num=2, **setting)
    batch, model, agent, episode = serve.build_workload(cfg, 2, device="cpu")
    seen = {"obs3d": [], "logits": [], "packs": 0, "bearing_inits": 0,
            "compacts": 0, "chains": 0, "chains_cn": 0}
    agent.register_forward_pre_hook(
        lambda _m, args: seen["obs3d"].append(args[1]))
    agent.register_forward_hook(
        lambda _m, _args, out: seen["logits"].append(out[:2]))
    from cmr_agent_tpu_torch.ops import kernels

    def counting(key, fn):
        def call(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)
        return call

    for key, obj, attr in (
            ("packs", kernels, "mask_compact_pack"),
            ("compacts", kernels, "segment_sum_count_image_compact"),
            ("chains", kernels, "fused_dense_chain"),
            ("chains_cn", kernels, "fused_dense_chain_cn"),
            ("bearing_inits", serve, "bearing_init_pose")):
        monkeypatch.setattr(obj, attr, counting(key, getattr(obj, attr)))
    final = episode(batch)
    assert final.shape == (2, 4, 4) and torch.isfinite(final).all()
    first, second = seen["obs3d"]
    fused_agent = name == "fused_stacks"
    assert seen["packs"] == (1 if value == "pack" else 0)
    assert seen["compacts"] == (cfg.action_num if (name, value) == (
        "raster_mode", "compact") else 0)
    assert seen["chains_cn"] == (4 * cfg.action_num if fused_agent else 0)
    assert seen["chains"] == (12 if value == "all" else 0)
    assert seen["bearing_inits"] == (1 if name == "bearing_init" else 0)
    # the fused agent reads the channel-major [B, C, N] observation
    channels = first.shape[1] if fused_agent else first.shape[-1]
    assert channels == (7 if cfg.obs_bearing_channels else 5)
    rows = first.shape[-1] if fused_agent else first.shape[1]
    assert rows == (1024 if name == "obs3d_source" else cfg.num_pt)
    dof = (3, 3) if name == "is_6_dof" else (1, 2)
    for r_logits, t_logits in seen["logits"]:
        assert (r_logits.shape, t_logits.shape) == ((2, dof[0], 11),
                                                    (2, dof[1], 11))
    xyz = (lambda o: o[:, :3]) if fused_agent else (lambda o: o[..., :3])
    # the static cloud is the same at every step; the moved one is not
    static = torch.equal(xyz(first), xyz(second))
    assert static == (name != "pose_aware_observation")
    assert agent.policy_r[0].in_features == 4 * cfg.embed_dim + (
        2 if name == "policy_aux_state" else 0)


def test_build_workload_on_cpu_runs_the_episode():
    cfg = tiny_config(raster_topk=1024, action_num=3)
    batch, model, agent, episode = serve.build_workload(cfg, 2, device="cpu")
    assert not model.training and not agent.training
    final = episode(batch)
    assert final.shape == (2, 4, 4) and torch.isfinite(final).all()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
