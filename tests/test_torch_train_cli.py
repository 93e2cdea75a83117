"""The port's 6-DoF agent, its compacted 3-D observation, and its three
training CLIs (``cli/train_geo.py``, ``cli/train_agent.py``,
``cli/train_iter.py``) vs the JAX package, on the CPU in f32.

JAX references: ``expert_action`` / ``apply_action`` (``is_6_dof``),
``run_episode`` and ``make_rollout_fn`` / ``make_ppo_update_step`` on
``micro_config(is_6_dof=True)`` through their XLA fallbacks, weights moved
through the bridge; ``observation_from_pose`` with ``obs3d_compact`` in its
cn layout (the nc layout rotates the compacted rows about their own
centroid, ROADMAP "Known places"); and the CLIs' pure functions. The CLIs
run on ``--tiny --device cpu`` with the tiny config swapped for
``micro_config`` (the JAX package's own CLI tests shrink it the same way),
synchronous loading, 4 training scenes (2 batches an epoch) and 2
validation scenes.
"""

import glob
import math
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmr_agent_tpu.cli import train_agent as jax_cli_agent
from cmr_agent_tpu.config import micro_config as jax_micro_config
from cmr_agent_tpu.data import SyntheticDataset, collate
from cmr_agent_tpu.env import environment as jax_env
from cmr_agent_tpu.env import init_poses as jax_init_poses
from cmr_agent_tpu.env import run_episode as jax_run_episode
from cmr_agent_tpu.ops import to_disentangled as jax_to_disentangled
from cmr_agent_tpu.train import train_agent as jax_train_agent
from cmr_agent_tpu.train.train_geo import create_geo_state, make_geo_forward
from cmr_agent_tpu_torch.cli import common
from cmr_agent_tpu_torch.cli import train_agent as cli_agent
from cmr_agent_tpu_torch.cli import train_geo as cli_geo
from cmr_agent_tpu_torch.cli import train_iter as cli_iter
from cmr_agent_tpu_torch.config import micro_config
from cmr_agent_tpu_torch.env import environment
from cmr_agent_tpu_torch.env.episode import run_episode
from cmr_agent_tpu_torch.models.agent import CMRAgent
from cmr_agent_tpu_torch.train import train_agent
from cmr_agent_tpu_torch.train.convert import flax_to_state_dict
from cmr_agent_tpu_torch.train.optim import Optimizer

B = 2
MARGIN = 1e-4
GEO_KEYS = ("pc", "pc_overlap_pred", "pc_geo_feat", "img_geo_feat")
BATCH_KEYS = ("img", "pc", "node", "pt2node", "K", "P", "pc_in_cam_space",
              "pc_mask")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rot(rx, ry, rz):
    """Extrinsic-xyz ``Rz Ry Rx`` (float64 numpy)."""
    cx, sx, cy, sy, cz, sz = (math.cos(rx), math.sin(rx), math.cos(ry),
                              math.sin(ry), math.cos(rz), math.sin(rz))
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _random_poses(rng, n, flip: bool):
    """``n`` random source/target pose pairs. With ``flip`` each delta
    rotation has an extrinsic-xyz roll in [3.02, 3.12] (the expert's flip
    branch, roll > 3 rad, clear of the +-pi branch cut where the two
    packages' f32 residues could pick opposite signs)."""
    P = np.tile(np.eye(4), (2, n, 1, 1))
    for i in range(n):
        P[0, i, :3, :3] = _rot(*rng.uniform(-0.4, 0.4, 3))
        delta = (_rot(rng.uniform(3.02, 3.12), rng.uniform(-1.2, 1.2),
                      rng.uniform(-3.0, 3.0)) if flip
                 else _rot(*rng.uniform(-0.4, 0.4, 3)))
        P[1, i, :3, :3] = delta @ P[0, i, :3, :3]
        P[:, i, :3, 3] = rng.uniform(-9, 9, (2, 3))
    return P.astype(np.float32)


@pytest.mark.parametrize("is_6_dof", [True, False])
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_expert_and_apply_action_match_jax(is_6_dof, flip, seed):
    """On 16 random pose pairs: the expert's actions equal JAX's (the flip
    branch fired for every pair where ``flip``), and the action applied to
    the source pose within 1e-6 of JAX's."""
    rng = np.random.default_rng(seed)
    src, tgt = _random_poses(rng, 16, flip)
    jcfg = jax_micro_config()
    r_steps, t_steps = jcfg.r_steps_array(), jcfg.t_steps_array()
    want_r, want_t = jax_env.expert_action(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(r_steps),
        jnp.asarray(t_steps), is_6_dof)
    got_r, got_t = environment.expert_action(_t(src), _t(tgt), _t(r_steps),
                                             _t(t_steps), is_6_dof)
    dof = (3, 3) if is_6_dof else (1, 2)
    assert (got_r.shape, got_t.shape) == ((16, dof[0]), (16, dof[1]))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    if flip:
        delta = tgt[:, :3, :3] @ np.swapaxes(src[:, :3, :3], 1, 2)
        roll = np.arctan2(delta[:, 2, 1], delta[:, 2, 2])
        assert np.all(np.abs(roll) > 3.0)
    want = jax_env.apply_action(want_r, want_t, jnp.asarray(src),
                                jnp.asarray(r_steps), jnp.asarray(t_steps),
                                is_6_dof)
    got = environment.apply_action(got_r, got_t, _t(src), _t(r_steps),
                                   _t(t_steps), is_6_dof)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.fixture(scope="module")
def six_dof():
    """Micro width, 6-DoF: the JAX geo outputs and agent weights (batch
    stats given values), the same weights in the port's agent."""
    jcfg, cfg = jax_micro_config(is_6_dof=True), micro_config(is_6_dof=True)
    assert (cfg.degree_r, cfg.degree_t) == (3, 3)
    ds = SyntheticDataset(jcfg, length=B, seed=21)
    full = collate([ds[i] for i in range(B)])
    jb = {k: jnp.asarray(v) for k, v in full.items()}
    geo_state = create_geo_state(jcfg, jb, jax.random.key(0))
    geo_out = make_geo_forward(jcfg)(geo_state.params,
                                     geo_state.batch_stats, jb)
    h, w, f = jcfg.image_h, jcfg.image_w, jcfg.embed_dim
    jstate = jax_train_agent.create_agent_state(
        jcfg, jnp.zeros((B, h, w, 2 * f)), jnp.zeros((B, jcfg.num_pt, 5)),
        jax.random.key(1))
    rng = np.random.default_rng(6)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.2, a.shape).astype(
            np.float32), jstate.batch_stats)
    jstate = jstate.replace(batch_stats=stats)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)

    def port_state():
        agent = CMRAgent(cfg)
        agent.load_state_dict(flax_to_state_dict(
            cfg, {"params": params, "batch_stats": stats}, "agent"))
        return train_agent.AgentTrainState(
            agent, Optimizer(cfg, agent.parameters()))

    return dict(jcfg=jcfg, cfg=cfg, jb=jb, geo_out=geo_out, jstate=jstate,
                port_state=port_state,
                tgeo={k: _t(geo_out[k]) for k in GEO_KEYS},
                tbatch={k: _t(full[k]) for k in BATCH_KEYS})


def test_six_dof_episode_matches_jax(six_dof):
    """The deterministic 10-step 6-DoF episode: 3 + 3 logits a step, each
    action equal to JAX's where its top-2 margin exceeds 1e-4; the final
    poses within 1e-4 when every action agreed."""
    jcfg, cfg, jstate = six_dof["jcfg"], six_dof["cfg"], six_dof["jstate"]
    jb, geo_out = six_dof["jb"], six_dof["geo_out"]
    state = {k: geo_out[k] for k in GEO_KEYS}
    state.update({k: jb[k] for k in ("K", "pc_in_cam_space", "pc_mask",
                                     "P")})
    pose_src, pose_tgt = jax_init_poses(state)
    pose_tgt = jax_to_disentangled(pose_tgt, state["pc"])
    want_final, traj = jax_run_episode(
        lambda v, o2, o3: jstate.apply_fn(v, o2, o3, train=False),
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, state,
        pose_src, pose_tgt, jcfg, deterministic=True,
        collect_trajectory=True, raster_topk=jcfg.episode_raster_topk())
    agent = six_dof["port_state"]().agent.eval()
    tstate = {k: _t(state[k]) for k in state}
    with torch.no_grad():
        final, steps, _ = run_episode(agent, tstate, _t(pose_src), cfg,
                                      cfg.episode_raster_topk())
    agreed = True
    for s, (r_logits, t_logits) in enumerate(steps):
        assert r_logits.shape == t_logits.shape == (B, 3, cfg.num_steps)
        for logits, key in ((r_logits, "action_r"), (t_logits, "action_t")):
            top2 = torch.topk(logits, 2, dim=-1).values
            sure = (top2[..., 0] - top2[..., 1] > MARGIN).numpy()
            got = logits.argmax(dim=-1).numpy()
            want = np.asarray(traj[key][s])
            np.testing.assert_array_equal(got[sure], want[sure])
            agreed &= bool(np.array_equal(got, want))
    if agreed:
        np.testing.assert_allclose(final.numpy(), np.asarray(want_final),
                                   atol=1e-4)


@pytest.fixture(scope="module")
def six_dof_train(six_dof):
    """One 6-DoF rollout at expert_beta=1.0 (every action the expert's, no
    random numbers) and one BC + PPO update on its first 4 rows, both
    packages."""
    jcfg, cfg = six_dof["jcfg"], six_dof["cfg"]
    want_traj, want_final, _ = jax_train_agent.make_rollout_fn(jcfg)(
        six_dof["jstate"], six_dof["geo_out"], six_dof["jb"],
        jax.random.key(2), jnp.asarray(1.0))
    want_traj = jax.tree_util.tree_map(np.asarray, want_traj)
    tstate = six_dof["port_state"]()
    got_traj, got_final, _ = train_agent.make_rollout_fn(cfg)(
        tstate, six_dof["tgeo"], six_dof["tbatch"],
        torch.Generator().manual_seed(3), expert_beta=1.0)
    from cmr_agent_tpu.env import buffer as jax_buffer
    jbuf = jax_buffer.TrajectoryBuffer(jcfg.gamma, jcfg.gae_lambda)
    jbuf.add(jax.tree_util.tree_map(jnp.asarray, want_traj))
    mb = {k: np.asarray(v[:jcfg.ppo_batch_size])
          for k, v in jbuf.samples().items()}
    _, want_metrics = jax_train_agent.make_ppo_update_step(jcfg)(
        six_dof["jstate"], {k: jnp.asarray(v) for k, v in mb.items()})
    got_metrics = train_agent.make_ppo_update_step(cfg)(
        tstate, {k: _t(v) for k, v in mb.items()})
    return dict(want_traj=want_traj, got_traj=got_traj,
                want_final=np.asarray(want_final), got_final=got_final,
                want_metrics=want_metrics, got_metrics=got_metrics)


@pytest.mark.parametrize("key,atol", [
    ("action_r", 0.0), ("action_t", 0.0), ("expert_action_r", 0.0),
    ("expert_action_t", 0.0), ("reward", 0.0), ("state_3d", 0.0),
    ("value", 1e-4), ("action_logprob", 1e-4), ("entropy", 1e-4)])
def test_six_dof_rollout_matches_jax(six_dof_train, key, atol):
    """Actions, expert labels and rewards exact (3 + 3 a step); values,
    log-probs and entropies (6 a step) within 1e-4."""
    got = six_dof_train["got_traj"][key]
    want = six_dof_train["want_traj"][key]
    assert tuple(got.shape) == want.shape, key
    if key in ("action_r", "action_t", "action_logprob"):
        assert got.shape[-1] == (6 if key == "action_logprob" else 3)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               atol=atol, rtol=0)


def test_six_dof_rollout_final_pose_matches_jax(six_dof_train):
    np.testing.assert_allclose(six_dof_train["got_final"].numpy(),
                               six_dof_train["want_final"], atol=1e-4)


@pytest.mark.parametrize("key", train_agent.METRIC_KEYS)
def test_six_dof_update_matches_jax(six_dof_train, key):
    got = six_dof_train["got_metrics"][key].item()
    want = float(six_dof_train["want_metrics"][key])
    assert abs(got - want) <= 1e-4 * abs(want) + 1e-6, (key, got, want)


# --------------------------------------------------------------------------
# the compacted 3-D observation
# --------------------------------------------------------------------------

def _feats(rng, b=2, n=600, h=8, w=16, f=6):
    K = np.array([[float(w), 0, w / 2], [0, float(w), h / 2], [0, 0, 1]],
                 np.float32)
    return {
        "pc": (rng.normal(size=(b, n, 3)) * [3, 1, 3] + [1, 0, 6]).astype(
            np.float32),
        "K": np.broadcast_to(K, (b, 3, 3)).copy(),
        "pc_overlap_pred": rng.uniform(size=(b, n)) < 0.4,
        "pc_is_in_cam_scores": rng.uniform(size=(b, n)).astype(np.float32),
        "pc_geo_feat": rng.normal(size=(b, n, f)).astype(np.float32),
        "img_geo_feat": rng.normal(size=(b, h, w, f)).astype(np.float32),
    }


def _yaw_pose(yaw, t, b=2):
    P = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    P[:, :3, :3] = _rot(0.0, yaw, 0.0)
    P[:, :3, 3] = t
    return P


def _compact_observations(pose_aware, k=160, yaw=0.7):
    """The JAX package's compacted observation in both layouts and the
    port's in both, at a nonzero yaw (k below the overlap count, so the
    compaction drops rows and its centroid is not the cloud's)."""
    feats = _feats(np.random.default_rng(4))
    pose = _yaw_pose(yaw, [0.5, 0.0, -0.8])
    kw = dict(pose_aware=pose_aware, bearing_channels=True)
    jstate = jax_env.compact_observation_state(
        {key: jnp.asarray(v) for key, v in feats.items()}, k)
    want = {layout: jax_env.observation_from_pose(
        jstate, jnp.asarray(pose), 8, 16, raster_mode="topk",
        obs3d_layout=layout, obs3d_compact=True, **kw)
        for layout in ("nc", "cn")}
    tstate = environment.compact_observation_state(
        {key: _t(v) for key, v in feats.items()}, k)
    got = {layout: environment.observation_from_pose(
        tstate, _t(pose), 8, 16, raster_mode="flat", obs3d_layout=layout,
        obs3d_compact=True, **kw) for layout in ("nc", "cn")}
    assert int(tstate["raster_dropped"].min()) > 0
    return want, got


@pytest.mark.parametrize("layout", ["nc", "cn"])
@pytest.mark.parametrize("pose_aware", [False, True])
def test_compact_observation_follows_jax_cn_path(layout, pose_aware):
    """The port's compacted observation, nc and cn, against the JAX cn
    path: the 3-D observation (k rows, 7 channels: the compacted points
    moved about the FULL cloud's centroid, their overlap flags, the
    in-frame flags, the bearing) within 1e-5; the 2-D one within 1e-5."""
    want, got = _compact_observations(pose_aware)
    w2, w3 = (np.asarray(a) for a in want["cn"])
    g2, g3 = (a.numpy() for a in got[layout])
    if layout == "nc":
        g3 = np.swapaxes(g3, 1, 2)
    assert g3.shape == w3.shape == (2, 7, 160)
    np.testing.assert_allclose(g3, w3, atol=1e-5)
    np.testing.assert_allclose(g2, w2, atol=1e-5)


def test_jax_nc_compact_rotates_about_the_subset_centroid():
    """JAX's nc path moves the compacted rows about their own centroid
    (``project(src_pc)``, environment.py:484-489), so at a nonzero yaw its
    pose-aware 3-D observation differs from its cn path's; the port's nc
    path equals the cn one. The fault is JAX's, not the port's."""
    want, got = _compact_observations(pose_aware=True)
    jax_nc = np.swapaxes(np.asarray(want["nc"][1]), 1, 2)
    jax_cn = np.asarray(want["cn"][1])
    moved = np.abs(jax_nc[:, :3] - jax_cn[:, :3]).max()
    assert moved > 1e-2, moved
    port_nc = np.swapaxes(got["nc"][1].numpy(), 1, 2)
    np.testing.assert_allclose(port_nc, jax_cn, atol=1e-5)


def test_episode_hands_an_unfused_agent_the_cn_observation_with_obs3d_cn():
    """``obs3d_cn`` (the JAX package's CMR_OBS3D_CN=1): an eval episode's
    unfused agent reads ``[B, C, N]``, and the actions equal the nc
    episode's."""
    from cmr_agent_tpu_torch import serve
    seen = []
    cfg = micro_config(raster_topk=256, action_num=2)
    batch, model, agent, _ = serve.build_workload(cfg, 2, device="cpu")
    agent.register_forward_pre_hook(lambda _m, a: seen.append(a[1].shape))
    import dataclasses
    out = {flag: serve.serve_episode(model, agent, dataclasses.replace(
        cfg, obs3d_cn=flag), batch) for flag in (False, True)}
    assert seen == [(2, cfg.num_pt, 5)] * 2 + [(2, 5, cfg.num_pt)] * 2
    for (a, b), (c, d) in zip(out[False]["steps"], out[True]["steps"]):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-5)
        torch.testing.assert_close(b, d, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# the CLIs' pure functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("over", [
    dict(), dict(num_trajectory=3, train_batch_size=5, action_num=7,
                 ppo_batch_size=4),
    dict(num_trajectory=1, train_batch_size=2, action_num=3,
         ppo_batch_size=10),
    dict(num_trajectory=2, train_batch_size=1, action_num=1,
         ppo_batch_size=3)])
def test_resume_step_and_updates_per_epoch_equal_jax(over):
    """Over a grid of optimizer steps and batch counts, bit for bit."""
    jcfg, cfg = jax_micro_config(**over), micro_config(**over)
    for opt_step in range(0, 200, 7):
        assert cli_agent.resume_rollout_step(cfg, opt_step) == \
            jax_cli_agent.resume_rollout_step(jcfg, opt_step), opt_step
    for batches in (0, 1, 2, 3, 7, 64, 1000):
        assert cli_agent.agent_updates_per_epoch(cfg, batches) == \
            jax_cli_agent.agent_updates_per_epoch(jcfg, batches), batches


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

@pytest.fixture
def micro_cli(monkeypatch, tmp_path):
    """``--tiny`` builds ``micro_config`` (val interval 1 where asked);
    returns ``argv(*extra)`` with the data, device and directories set."""
    state = {"val_interval": 500}
    monkeypatch.setattr(common, "tiny_config", lambda **o: micro_config(
        val_interval=state["val_interval"], **o))

    def argv(*extra, val_interval=500):
        state["val_interval"] = val_interval
        return ["--tiny", "--device", "cpu", "--synthetic-length", "4",
                "--val-length", "2", "--loader-backend", "sync",
                "--ckpt-dir", str(tmp_path / "ck"), "--logdir",
                str(tmp_path / "log")] + list(extra)
    argv.root = tmp_path
    return argv


def _ckpts(root):
    return sorted(os.path.relpath(os.path.dirname(p), root)
                  for p in glob.glob(str(root / "ck" / "**" / "model"),
                                     recursive=True))


def test_train_geo_cli_saves_only_on_improvement(micro_cli, capsys):
    """Validating every step, a checkpoint is written exactly at the steps
    whose validation loss beat every earlier one, named
    ``epoch-E-step-S``."""
    state = cli_geo.main(micro_cli("--steps", "4", val_interval=1))
    assert state.step == 4
    vals = [(int(s), float(v)) for s, v in re.findall(
        r"\[val\] step (\d+) loss ([\d.]+)", capsys.readouterr().out)]
    assert [s for s, _ in vals] == [0, 1, 2, 3]
    best, improved = float("inf"), []
    for s, v in vals:
        if v < best:
            best = v
            improved.append(s)
    names = _ckpts(micro_cli.root)
    assert [int(n.rsplit("-", 1)[1]) for n in names] == improved, names
    assert all(re.search(r"/epoch-\d-step-\d$", n) for n in names)


def test_train_geo_cli_steps_per_dispatch_drops_the_tail(micro_cli, capsys,
                                                         monkeypatch):
    """``--steps-per-dispatch 2`` over 3 batches an epoch: one multi-step
    a epoch (the third batch dropped), 4 steps in 2 epochs, the metrics
    logged for every step."""
    calls = []
    make = cli_geo.make_geo_multi_step

    def counting(cfg, s):
        fn = make(cfg, s)

        def call(state, stacked, gen):
            calls.append(stacked["pc"].shape[0])
            print("[multi-step]")
            return fn(state, stacked, gen)
        return call
    monkeypatch.setattr(cli_geo, "make_geo_multi_step", counting)
    argv = micro_cli("--steps", "4", "--steps-per-dispatch", "2")
    argv[argv.index("--synthetic-length") + 1] = "6"
    state = cli_geo.main(argv)
    out = capsys.readouterr().out
    assert calls == [2, 2] and state.step == 4
    assert out.index("[multi-step]") < out.index("epoch 0 done") < \
        out.rindex("[multi-step]")
    assert "step cap reached (4)" in out


def test_train_geo_cli_stop_file_and_resume(micro_cli, capsys, monkeypatch):
    """A stop file that appears after the second step checkpoints at step
    2 (``stop-epoch-1-step-2``) and exits; ``--resume`` from it continues
    at step 2 with the optimizer state and stops at the cap."""
    stop = micro_cli.root / "stop"
    make = cli_geo.make_geo_train_step

    def stopping(cfg):
        fn = make(cfg)

        def call(state, batch, gen):
            out = fn(state, batch, gen)
            if state.step == 2:
                stop.touch()
            return out
        return call
    monkeypatch.setattr(cli_geo, "make_geo_train_step", stopping)
    state = cli_geo.main(micro_cli("--steps", "6", "--stop-file",
                                   str(stop)))
    assert state.step == 2
    ckpt, = glob.glob(str(micro_cli.root / "ck" / "*" / "stop-*"))
    assert ckpt.endswith("stop-epoch-1-step-2")
    capsys.readouterr()
    monkeypatch.setattr(cli_geo, "make_geo_train_step", make)
    state = cli_geo.main(micro_cli("--steps", "3", "--resume", ckpt))
    out = capsys.readouterr().out
    assert f"resumed from {ckpt} at step 2 (optimizer state restored)" in out
    assert state.step == 3 and "step cap reached (3)" in out


def test_train_agent_cli_flushes_and_gates_checkpoints(micro_cli, capsys):
    """``--steps 2`` with ``num_trajectory`` 2: one buffer flush of full
    minibatches, validation at step 0 saved (either metric improved), the
    annealed expert mixing on."""
    state = cli_agent.main(micro_cli("--steps", "2", "--expert-beta-frac",
                                     "0.5"))
    cfg = micro_config()
    n_up = cfg.num_trajectory * cfg.train_batch_size * cfg.action_num \
        // cfg.ppo_batch_size
    assert state.step == n_up
    out = capsys.readouterr().out
    assert re.search(r"\[val\] step 0 RRE [\d.]+ RTE [\d.]+ lr 1.00e-03",
                     out), out
    names = _ckpts(micro_cli.root)
    assert len(names) == 1 and names[0].endswith("epoch-0-step-0"), names


@pytest.mark.parametrize("remat", [False, True])
def test_train_iter_cli_always_saves_the_final_checkpoint(micro_cli, capsys,
                                                          remat):
    """``--steps 3``: the step-0 validation saves (it improves on inf) and
    the cap always saves the final state, with or without ``--remat``."""
    extra = ["--remat"] if remat else []
    state = cli_iter.main(micro_cli("--steps", "3", "--unmasked-warp",
                                    *extra))
    assert state.step == 3 and state.model.cfg.cost_volume_remat == remat
    out = capsys.readouterr().out
    assert re.search(r"\[val\] step 0 cv_loss [\d.]+ grid_acc [\d.]+ "
                     r"ry/tx/tz [\d./]+ 1bin [\d./]+ lr", out), out
    assert "saved final checkpoint at step 3" in out
    assert _ckpts(micro_cli.root) == ["ck/iter_micro/epoch-0-step-0",
                                      "ck/iter_micro/epoch-1-step-3"]


@pytest.mark.parametrize("cli,extra", [
    (cli_geo, ("--steps", "2")),
    (cli_geo, ("--steps", "2", "--steps-per-dispatch", "2")),
    (cli_agent, ("--steps", "2")),
    (cli_iter, ("--steps", "2", "--unmasked-warp"))])
def test_training_clis_train_in_bf16(micro_cli, cli, extra):
    """``--dtype bfloat16`` trains as the JAX package's CLIs do, the geo
    CLI also through the multi-step (on the CPU a loop of eager steps):
    every dense and conv layer the run calls puts out bf16, and every
    checkpoint it writes holds f32 parameters, running stats and Adam
    moments, finite."""
    seen = set()

    def hook(module, args, out):
        if isinstance(module, (torch.nn.Linear, torch.nn.Conv2d)):
            seen.add(out.dtype)
    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        state = cli.main(micro_cli(*extra, "--dtype", "bfloat16"))
    finally:
        handle.remove()
    assert seen == {torch.bfloat16}
    assert state.step >= 2
    files = glob.glob(str(micro_cli.root / "ck" / "**" / "model"),
                      recursive=True)
    assert files
    for path in files:
        saved = [torch.load(path, weights_only=True)["module"],
                 torch.load(os.path.join(os.path.dirname(path), "opt"),
                            weights_only=True)["optimizer"]["state"]]
        tensors = list(saved[0].values()) + [
            v for st in saved[1].values() for v in st.values()
            if torch.is_tensor(v) and v.ndim > 0]
        floats = [t for t in tensors if t.is_floating_point()]
        assert floats and all(t.dtype == torch.float32 for t in floats)
        assert all(torch.isfinite(t).all() for t in floats)


def test_profile_flag_writes_a_trace(micro_cli):
    trace = micro_cli.root / "prof"
    cli_geo.main(micro_cli("--steps", "1", "--profile", str(trace)))
    assert (trace / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("before", [False, True])
def test_training_cli_runs_at_tf32_inside_the_run_only(micro_cli, monkeypatch,
                                                       before):
    """A training CLI's steps run with cuBLAS's and cuDNN's TF32 switches
    on, and ``main`` puts the caller's settings back when it returns."""
    seen = []
    make = cli_geo.make_geo_train_step

    def recording(cfg):
        fn = make(cfg)

        def call(state, batch, gen):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return fn(state, batch, gen)
        return call
    monkeypatch.setattr(cli_geo, "make_geo_train_step", recording)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", before)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", before)
    cli_geo.main(micro_cli("--steps", "2"))
    assert seen == [(True, True)] * 2
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == (before, before)


def test_synthetic_batch_is_a_fresh_copy_of_the_dataset_batch():
    """``serve.synthetic_batch`` keeps the collated host batch for the next
    call with the same config, size and seed, and hands every call tensors
    of its own, equal to the dataset's batch."""
    from cmr_agent_tpu_torch import serve
    from cmr_agent_tpu_torch.data import SyntheticDataset as TorchDataset
    from cmr_agent_tpu_torch.data import collate as torch_collate
    from cmr_agent_tpu_torch.data.synthetic import sample_settings
    cfg = micro_config()
    first = serve.synthetic_batch(cfg, B, "cpu", seed=3)
    first["pc"].add_(1.0)
    second = serve.synthetic_batch(cfg, B, "cpu", seed=3)
    ds = TorchDataset(cfg, length=B, seed=3)
    want = torch_collate([ds[i] for i in range(B)])
    for k, v in second.items():
        np.testing.assert_array_equal(v.numpy(), want[k])
    assert not torch.equal(first["pc"], second["pc"])
    other = serve.synthetic_batch(cfg, B, "cpu", seed=4)
    assert not torch.equal(other["pc"], second["pc"])
    # a setting the dataset does not read shares the batch; one it reads
    # makes its own
    same = serve.synthetic_batch(micro_config(compute_dtype="bfloat16"), B,
                                 "cpu", seed=3)
    assert all(torch.equal(same[k], second[k]) for k in second)
    wider = micro_config(p_tx_amplitude=2 * cfg.p_tx_amplitude)
    assert sample_settings(wider) != sample_settings(cfg)
    moved = serve.synthetic_batch(wider, B, "cpu", seed=3)
    assert not torch.equal(moved["P"], second["P"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
