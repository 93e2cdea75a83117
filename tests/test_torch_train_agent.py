"""The port's agent training path (BC + PPO) vs the JAX package on
``micro_config()``.

JAX references: the XLA fallbacks on the CPU throughout (the JAX episode
rasters the full cloud through ``batched_segment_mean``; the port compacts
to ``num_pt`` rows and runs its flat raster's plain version, which gives
the same pixels). Geometry, expert and reward against the JAX functions of
``ops/geometry.py`` and ``env/environment.py``; the rollout against
``train/train_agent.py:make_rollout_fn`` with ``expert_beta=1.0``, which
makes every action the expert's and the trajectory free of random numbers;
the buffer against ``env/buffer.py``; the update against
``make_ppo_update_step`` with its optimizer swapped for one that hands
the gradients back. Weights and gradients move through the weight bridge
(``flax_to_state_dict``; its transforms are linear).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from cmr_agent_tpu.config import micro_config as jax_micro_config
from cmr_agent_tpu.data import SyntheticDataset, collate
from cmr_agent_tpu.env import buffer as jax_buffer
from cmr_agent_tpu.env import environment as jax_env
from cmr_agent_tpu.ops import geometry as jax_geometry
from cmr_agent_tpu.train import train_agent as jax_train_agent
from cmr_agent_tpu.train.train_geo import create_geo_state, make_geo_forward
from cmr_agent_tpu_torch.config import micro_config
from cmr_agent_tpu_torch.env import buffer, environment
from cmr_agent_tpu_torch.models.agent import CMRAgent, sample_categorical
from cmr_agent_tpu_torch.ops import geometry, kernels
from cmr_agent_tpu_torch.train import train_agent
from cmr_agent_tpu_torch.train.convert import flax_to_state_dict
from cmr_agent_tpu_torch.train.optim import Optimizer

B = 2
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


def _poses(angles, seed):
    rng = np.random.default_rng(seed)
    P = np.tile(np.eye(4), (len(angles), 1, 1))
    for i, a in enumerate(angles):
        P[i, :3, :3] = _rot(*a)
        P[i, :3, 3] = rng.uniform(-9, 9, 3)
    return P.astype(np.float32)


# source/target rotation pairs: a general pose; a yaw beyond pi/2, whose
# delta decomposes with a roll of +-pi (the expert's flip branch); and a
# pitch of exactly pi/2 (gimbal lock in both euler conventions)
POSE_CASES = {
    "general": ([(0.1, -0.4, 0.2), (0.0, 1.0, 0.0)],
                [(-0.2, 0.7, 0.3), (0.05, -0.3, -0.1)]),
    "flip": ([(0.0, 0.0, 0.0), (0.0, 0.3, 0.0)],
             [(0.0, 2.6, 0.0), (0.0, -2.9, 0.0)]),
    "gimbal": ([(0.0, 0.0, 0.0), (0.3, 0.0, 0.0)],
               [(0.4, math.pi / 2, 0.2), (0.3, -math.pi / 2, -0.6)]),
}


@pytest.mark.parametrize("case", sorted(POSE_CASES))
def test_euler_pose_diff_and_expert_action_match_jax(case):
    """Both euler extractions, pose_diff (RTE, RRE) and the expert's
    actions, atol 1e-5 rad / 1e-3 deg; actions exact."""
    src_a, tgt_a = POSE_CASES[case]
    src, tgt = _poses(src_a, 1), _poses(tgt_a, 2)
    if case == "flip":
        src[:, :3, 3] = tgt[:, :3, 3] = 0.0
    jcfg = jax_micro_config()
    r_steps, t_steps = jcfg.r_steps_array(), jcfg.t_steps_array()
    delta = tgt[:, :3, :3] @ np.swapaxes(src[:, :3, :3], 1, 2)

    want = np.asarray(jax_geometry.matrix_to_euler_xyz_extrinsic(delta))
    got = geometry.matrix_to_euler_xyz_extrinsic(_t(delta)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if case == "flip":
        assert np.all(want[:, 0] > 3.0)
    want = np.asarray(jax_geometry.matrix_to_euler_intrinsic_xyz_degrees(
        delta))
    got = geometry.matrix_to_euler_intrinsic_xyz_degrees(_t(delta)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)

    want_te, want_re = jax_geometry.pose_diff(jnp.asarray(src),
                                              jnp.asarray(tgt))
    got_te, got_re = geometry.pose_diff(_t(src), _t(tgt))
    np.testing.assert_allclose(got_te.numpy(), np.asarray(want_te),
                               atol=1e-5)
    np.testing.assert_allclose(got_re.numpy(), np.asarray(want_re),
                               atol=1e-3)

    want_r, want_t = jax_env.expert_action(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(r_steps),
        jnp.asarray(t_steps))
    got_r, got_t = environment.expert_action(_t(src), _t(tgt), _t(r_steps),
                                             _t(t_steps))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("apply_pose", [True, False])
def test_step_reward_matches_jax(apply_pose):
    rng = np.random.default_rng(3)
    n = 300
    state = {"pc": rng.normal(size=(3, n, 3)).astype(np.float32) * 5,
             "pc_in_cam_space": rng.normal(size=(3, n, 3)).astype(
                 np.float32) * 5,
             "pc_mask": rng.uniform(size=(3, n)) < 0.6}
    state["pc_mask"][2] = False                      # no masked point
    pose = _poses([(0.0, 0.2, 0.0), (0.0, -1.0, 0.0), (0.0, 0.4, 0.0)], 4)
    prev = rng.uniform(20, 80, size=(3, 1, 1)).astype(np.float32)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: _t(v) for k, v in state.items()}
    for p in (None, prev):
        want_r, want_d = jax_env.step_reward(
            jnp.asarray(pose), jstate,
            None if p is None else jnp.asarray(p), apply_pose=apply_pose)
        got_r, got_d = environment.step_reward(
            _t(pose), tstate, None if p is None else _t(p),
            apply_pose=apply_pose)
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


@pytest.mark.parametrize("gae_lambda", [0.95, 0.0])
def test_buffer_returns_and_gae_match_jax(gae_lambda):
    """Two trajectories of K=4 steps at B=3: every key flattened in
    (step, batch) order, returns and advantages within 1e-6."""
    rng = np.random.default_rng(5)
    k, b = 4, 3
    trajs = []
    for _ in range(2):
        trajs.append({
            "state_2d": rng.normal(size=(k, b, 2, 3, 4)).astype(np.float32),
            "state_3d": rng.normal(size=(k, b, 6, 5)).astype(np.float32),
            "value": rng.normal(size=(k, b, 1, 1)).astype(np.float32),
            "reward": rng.choice([-0.5, 0.0, 0.5], (k, b, 1, 1)).astype(
                np.float32),
            "expert_action_r": rng.integers(0, 11, (k, b, 1)),
            "expert_action_t": rng.integers(0, 11, (k, b, 2)),
            "action_r": rng.integers(0, 11, (k, b, 1)),
            "action_t": rng.integers(0, 11, (k, b, 2)),
            "action_logprob": rng.normal(size=(k, b, 3)).astype(np.float32),
        })
    jbuf = jax_buffer.TrajectoryBuffer(0.9, gae_lambda)
    tbuf = buffer.TrajectoryBuffer(0.9, gae_lambda)
    for tr in trajs:
        jbuf.add({key: jnp.asarray(v) for key, v in tr.items()})
        tbuf.add({key: _t(v) for key, v in tr.items()})
    want, got = jbuf.samples(), tbuf.samples()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-6, err_msg=key)
    assert got["returns"].shape == (2 * k * b, 1, 1)


def test_seeded_categorical_sampler_frequencies():
    """200k draws per row of two distributions: each class's frequency
    within 4 sigma of softmax(logits); the same seed draws the same."""
    logits = torch.tensor([[2.0, 0.5, -1.0, 0.0], [-3.0, 1.0, 1.0, 0.2]])
    n = 200_000
    draws = sample_categorical(logits.expand(n, 2, 4),
                               torch.Generator().manual_seed(7))
    again = sample_categorical(logits.expand(n, 2, 4),
                               torch.Generator().manual_seed(7))
    assert torch.equal(draws, again)
    p = torch.softmax(logits, dim=-1)
    for row in range(2):
        freq = torch.bincount(draws[:, row], minlength=4).double() / n
        sigma = torch.sqrt(p[row] * (1 - p[row]) / n).double()
        assert torch.all((freq - p[row]).abs() <= 4 * sigma + 1e-12), row


def _capture_grads():
    """An optax transform whose update is zero and whose state becomes the
    gradient tree, so the JAX update step hands its gradients back."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(updates, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, updates), updates
    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def agent_run():
    """One rollout at expert_beta=1.0 and one BC + PPO update of both
    packages from the same weights, geo outputs and batch."""
    jcfg, cfg = jax_micro_config(), micro_config()
    ds = SyntheticDataset(jcfg, length=B, seed=21)
    full = collate([ds[i] for i in range(B)])
    batch_np = {k: full[k] for k in BATCH_KEYS}
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
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    jstate = jstate.replace(batch_stats=stats)
    want_traj, want_final, want_tgt = jax_train_agent.make_rollout_fn(jcfg)(
        jstate, geo_out, jb, jax.random.key(2), jnp.asarray(1.0))
    want_traj = jax.tree_util.tree_map(np.asarray, want_traj)

    agent = CMRAgent(cfg)
    agent.load_state_dict(flax_to_state_dict(
        cfg, {"params": params, "batch_stats": stats}, "agent"))
    tstate = train_agent.AgentTrainState(agent,
                                         Optimizer(cfg, agent.parameters()))
    tgeo = {k: _t(geo_out[k]) for k in GEO_KEYS}
    tbatch = {k: _t(v) for k, v in batch_np.items()}
    raster_calls = []
    real = kernels.segment_mean_count_image
    kernels.segment_mean_count_image = lambda *a, **k: (
        raster_calls.append(1), real(*a, **k))[1]
    try:
        got_traj, got_final, got_tgt = train_agent.make_rollout_fn(cfg)(
            tstate, tgeo, tbatch, torch.Generator().manual_seed(3),
            expert_beta=1.0)
    finally:
        kernels.segment_mean_count_image = real

    # one update on the same minibatch: the first ppo_batch_size rows of
    # the JAX trajectory's samples
    jbuf = jax_buffer.TrajectoryBuffer(jcfg.gamma, jcfg.gae_lambda)
    jbuf.add(jax.tree_util.tree_map(jnp.asarray, want_traj))
    mb = {k: np.asarray(v[:jcfg.ppo_batch_size])
          for k, v in jbuf.samples().items()}
    cap = _capture_grads()
    jstate = jstate.replace(tx=cap, opt_state=cap.init(jstate.params))
    new_jstate, want_metrics = jax_train_agent.make_ppo_update_step(jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in mb.items()})
    want_grads = flax_to_state_dict(
        cfg, {"params": jax.tree_util.tree_map(np.asarray,
                                               new_jstate.opt_state),
              "batch_stats": stats}, "agent")
    want_stats = flax_to_state_dict(
        cfg, {"params": params, "batch_stats": jax.tree_util.tree_map(
            np.asarray, new_jstate.batch_stats)}, "agent")

    # the gradients as the optimizer receives them, before its clipping
    grads = {}
    step = tstate.optimizer.step

    def record_and_step():
        grads.update({n: p.grad.detach().clone()
                      for n, p in agent.named_parameters()})
        step()
    tstate.optimizer.step = record_and_step
    params_before = {n: p.detach().clone()
                     for n, p in agent.named_parameters()}
    got_metrics = train_agent.make_ppo_update_step(cfg)(
        tstate, {k: _t(v) for k, v in mb.items()})
    return dict(want_traj=want_traj, want_final=np.asarray(want_final),
                want_tgt=np.asarray(want_tgt), got_traj=got_traj,
                got_final=got_final, got_tgt=got_tgt,
                raster_calls=len(raster_calls), cfg=cfg,
                want_metrics=want_metrics, got_metrics=got_metrics,
                want_grads=want_grads, grads=grads, want_stats=want_stats,
                agent=agent, params_before=params_before, state=tstate)


def test_expert_rollout_actions_and_poses_match_jax(agent_run):
    """expert_beta=1.0: the actions taken equal the expert's and the JAX
    rollout's exactly; final pose and target within 1e-4. The flat
    pixel-id raster ran once per step."""
    want, got = agent_run["want_traj"], agent_run["got_traj"]
    for key in ("action_r", "action_t", "expert_action_r",
                "expert_action_t"):
        np.testing.assert_array_equal(got[key].numpy(), want[key],
                                      err_msg=key)
    assert torch.equal(got["action_r"], got["expert_action_r"])
    np.testing.assert_allclose(agent_run["got_final"].numpy(),
                               agent_run["want_final"], atol=1e-4)
    np.testing.assert_allclose(agent_run["got_tgt"].numpy(),
                               agent_run["want_tgt"], atol=1e-5)
    assert agent_run["raster_calls"] == agent_run["cfg"].action_num


@pytest.mark.parametrize("key,atol", [
    ("state_2d", 1e-5), ("state_3d", 0.0), ("value", 1e-4),
    ("action_logprob", 1e-4), ("entropy", 1e-4), ("reward", 0.0)])
def test_expert_rollout_trajectory_matches_jax(agent_run, key, atol):
    """States (2-D: raster means summed in another order), values,
    log-probs and entropies (the agent's f32 sums) and rewards (+-0.5 on
    exact comparisons of equal poses' distances)."""
    got = agent_run["got_traj"][key]
    want = agent_run["want_traj"][key]
    assert tuple(got.shape) == want.shape, key
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("key", train_agent.METRIC_KEYS)
def test_ppo_update_loss_terms_match_jax(agent_run, key):
    got = agent_run["got_metrics"][key].item()
    want = float(agent_run["want_metrics"][key])
    assert abs(got - want) <= 1e-4 * abs(want) + 1e-6, (key, got, want)


def test_ppo_update_gradients_and_stats_match_jax(agent_run):
    """Every parameter's gradient per tensor within 1e-4 max|g| + 1e-6
    (the gradient before clipping: both clip inside the optimizer); the
    BatchNorm running stats after the step within 1e-5; the port's
    optimizer moved every parameter that had a nonzero gradient."""
    agent = agent_run["agent"]
    for name, g in agent_run["grads"].items():
        want = agent_run["want_grads"][name].numpy()
        tol = 1e-4 * np.abs(want).max() + 1e-6
        assert np.abs(g.numpy() - want).max() <= tol, name
    for name, buf in agent.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(),
                                       agent_run["want_stats"][name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    assert agent_run["state"].step == 1
    for name, p in agent.named_parameters():
        if agent_run["grads"][name].abs().max() > 0:
            assert not torch.equal(p.detach(),
                                   agent_run["params_before"][name]), name


def test_agent_training_loop_runs_on_cpu():
    """The CLI's loop on the port (cli/train_agent.py:251-291): sampled
    rollouts into the buffer, shuffled full minibatches through the
    update, then a validation episode; everything finite."""
    cfg = micro_config()
    ds = SyntheticDataset(jax_micro_config(), length=B, seed=2)
    batch = {k: _t(v) for k, v in collate([ds[i] for i in range(B)]).items()
             if k in BATCH_KEYS}
    from cmr_agent_tpu_torch.train import train_geo
    geo_state = train_geo.create_geo_state(cfg, device="cpu", seed=0)
    geo_out = train_geo.make_geo_forward(cfg)(geo_state.model, batch)
    state = train_agent.create_agent_state(cfg, device="cpu", seed=1)
    rollout = train_agent.make_rollout_fn(cfg)
    update = train_agent.make_ppo_update_step(cfg)
    gen = torch.Generator().manual_seed(0)
    buf = buffer.TrajectoryBuffer(cfg.gamma, cfg.gae_lambda)
    for _ in range(cfg.num_trajectory):
        traj, final, _ = rollout(state, geo_out, batch, gen)
        assert torch.isfinite(final).all()
        buf.add(traj)
    samples = buf.samples()
    n = samples["state_2d"].shape[0]
    assert n == cfg.num_trajectory * cfg.action_num * B
    order = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    for s in range(0, n - cfg.ppo_batch_size + 1, cfg.ppo_batch_size):
        rows = order[s:s + cfg.ppo_batch_size]
        metrics = update(state, {k: v[rows] for k, v in samples.items()})
        assert all(torch.isfinite(v) for v in metrics.values())
    assert state.step == n // cfg.ppo_batch_size
    final, rte, rre = train_agent.make_val_episode_fn(cfg)(state, geo_out,
                                                           batch)
    assert rte.shape == (B,) and rre.shape == (B,)
    assert torch.isfinite(rte).all() and torch.isfinite(rre).all()


@pytest.mark.parametrize("dtype,training,want", [
    ("float32", False, None), ("float32", True, None),
    ("bfloat16", False, torch.int8), ("bfloat16", True, torch.bfloat16)])
def test_training_episodes_never_raster_in_int8(dtype, training, want):
    """episode.py:151-155: int8 operands only in bf16 eval episodes."""
    from cmr_agent_tpu_torch.env.episode import raster_dtype_for
    cfg = micro_config(compute_dtype=dtype, raster_int8=True)
    assert raster_dtype_for(cfg, training=training) == want
