"""Agent training: imitation (BC) + PPO (PyTorch twin of the JAX package's
``train/train_agent.py:28-199``; reference Train_Agent.py:164-317).

A stochastic rollout of the frozen geo outputs with expert labels and
rewards (the agent in ``eval()`` mode, as the reference keeps it) fills
the trajectory buffer; the update is one BC + clipped-PPO minibatch step
with the agent in ``train()`` mode. As in :mod:`.train_geo`, the update
changes the agent and the optimizer in place where the JAX step returns a
new state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..config import Config
from ..env.environment import bearing_init_pose, init_poses
from ..env.episode import run_episode
from ..models.agent import CMRAgent, action_logprob_and_entropy
from ..ops.geometry import pose_diff, to_disentangled
from ..ops.losses import softmax_cross_entropy
from ..serve import init_random_, resolve_device
from .optim import Optimizer

METRIC_KEYS = ("loss", "bc_loss", "ppo_loss", "policy_loss", "value_loss",
               "entropy")


@dataclasses.dataclass
class AgentTrainState:
    agent: CMRAgent
    optimizer: Optimizer

    @property
    def step(self) -> int:
        return self.optimizer.count


def create_agent_state(cfg: Config, device="cuda", seed: int = 0,
                       steps_per_epoch: int = 1000) -> AgentTrainState:
    """A ``CMRAgent`` with random weights from a generator seeded with
    ``seed``, on ``device`` (CUDA unless asked otherwise), and its
    optimizer."""
    agent = CMRAgent(cfg)
    init_random_(agent, torch.Generator().manual_seed(seed))
    agent.to(resolve_device(device))
    return AgentTrainState(agent, Optimizer(cfg, agent.parameters(),
                                            steps_per_epoch))


def episode_state(geo_out: Dict, batch: Dict) -> Dict:
    """The frozen episode state from the geo outputs and the batch."""
    state = {k: geo_out[k] for k in ("pc", "pc_overlap_pred", "pc_geo_feat",
                                     "img_geo_feat")}
    state.update({k: batch[k] for k in ("K", "pc_in_cam_space", "pc_mask",
                                        "P")})
    return state


def _poses(cfg: Config, state):
    """Episode start (the identity, or the bearing yaw with
    ``cfg.bearing_init``) and the disentangled target."""
    pose_src, pose_tgt = init_poses(state)
    if cfg.bearing_init:
        pose_src = bearing_init_pose(state)
    return pose_src, to_disentangled(pose_tgt, state["pc"])


def make_rollout_fn(cfg: Config, reward_apply_pose: bool = True):
    """``(agent_state, geo_out, batch, generator, expert_beta=None) ->
    (trajectory, final_pose, pose_target)``: the stochastic rollout with
    expert labels, actions sampled from ``generator`` (on the agent's
    device); ``expert_beta`` is DAgger's scheduled sampling (see
    :func:`..env.episode.run_episode`)."""

    def rollout(agent_state: AgentTrainState, geo_out, batch,
                generator: torch.Generator,
                expert_beta: Optional[float] = None):
        agent = agent_state.agent.eval()
        state = episode_state(geo_out, batch)
        pose_src, pose_tgt = _poses(cfg, state)
        with torch.no_grad():
            final, _, traj = run_episode(
                agent, state, pose_src, cfg, cfg.episode_raster_topk(),
                pose_target=pose_tgt, deterministic=False,
                generator=generator, with_expert=True,
                collect_trajectory=True, reward_apply_pose=reward_apply_pose,
                expert_beta=expert_beta)
        return traj, final, pose_tgt

    return rollout


def make_ppo_update_step(cfg: Config, mesh=None):
    """``(agent_state, minibatch) -> metrics``: one BC + PPO step
    (Train_Agent.py:263-305) on rows ``state_2d, state_3d,
    expert_action_r/t, action_r/t, action_logprob, returns, advantage``.
    Metrics are 0-d tensors (no host sync). With a
    :class:`..parallel.mesh.Mesh` the rows are this rank's dp shard of the
    minibatch, and the BatchNorm statistics, gradients and metrics are the
    whole minibatch's (as :func:`.train_geo.make_geo_train_step`)."""
    from ..parallel.mesh import average_gradients, mean_over, use_mesh

    def update(agent_state: AgentTrainState, mb: Dict[str, torch.Tensor]):
        with use_mesh(mesh):
            metrics = _update(agent_state, mb)
        return metrics if mesh is None else mean_over(metrics, METRIC_KEYS,
                                                      mesh)

    def _update(agent_state: AgentTrainState, mb: Dict[str, torch.Tensor]):
        agent = agent_state.agent.train()
        agent_state.optimizer.zero_grad()
        r_logits, t_logits, value = agent(mb["state_2d"], mb["state_3d"])

        # behaviour cloning: CE against the expert's actions
        bc_loss = (softmax_cross_entropy(r_logits.reshape(-1, cfg.num_steps),
                                         mb["expert_action_r"].reshape(-1))
                   + softmax_cross_entropy(
                       t_logits.reshape(-1, cfg.num_steps),
                       mb["expert_action_t"].reshape(-1)))

        logprob, entropy = action_logprob_and_entropy(
            r_logits, t_logits, mb["action_r"], mb["action_t"])
        # the importance ratio bounded in log space (train_agent.py:131-140:
        # off-policy rows can have log-probs near -30, whose exp overflows)
        ratio = torch.exp((logprob - mb["action_logprob"]).clamp(-2.0, 2.0))
        adv = mb["advantage"].reshape(-1, 1)
        policy_loss = -torch.minimum(
            ratio * adv,
            ratio.clamp(1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv).mean()
        value_loss = ((value.reshape(-1, 1) - mb["returns"].reshape(-1, 1))
                      ** 2).mean()
        entropy_loss = entropy.mean()
        ppo_loss = (policy_loss + value_loss * cfg.w_value
                    - entropy_loss * cfg.w_entropy)
        loss = bc_loss + cfg.alpha * ppo_loss
        loss.backward()
        if mesh is not None:
            average_gradients(agent, mesh)
        agent_state.optimizer.step()
        return {"loss": loss.detach(), "bc_loss": bc_loss.detach(),
                "ppo_loss": ppo_loss.detach(),
                "policy_loss": policy_loss.detach(),
                "value_loss": value_loss.detach(),
                "entropy": entropy_loss.detach()}

    return update


def make_val_episode_fn(cfg: Config):
    """``(agent_state, geo_out, batch) -> (final_pose, RTE [B], RRE [B])``:
    the deterministic eval episode against the disentangled ground truth
    (Train_Agent.py:170-203)."""

    def val_episode(agent_state: AgentTrainState, geo_out, batch):
        agent = agent_state.agent.eval()
        state = episode_state(geo_out, batch)
        pose_src, pose_tgt = _poses(cfg, state)
        with torch.no_grad():
            final, _, _ = run_episode(agent, state, pose_src, cfg,
                                      cfg.episode_raster_topk())
        rte, rre = pose_diff(final, pose_tgt)
        return final, rte, rre

    return val_episode
