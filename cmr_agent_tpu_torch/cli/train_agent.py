"""Train the refinement agent by imitation + PPO (counterpart of the JAX
package's ``cli/train_agent.py``; reference Train_Agent.py).

Loads a frozen geo model (``--geo-ckpt``: a port train checkpoint or
snapshot, a weight export or the Orbax tree it came from; random
weights when empty), rolls out trajectories with
expert labels, and optimises BC + PPO on full minibatches of the flushed
buffer.

Usage::

    python -m cmr_agent_tpu_torch.cli.train_agent --dataset synthetic \\
        --steps 4                        # fresh random geo (smoke)
    python -m cmr_agent_tpu_torch.cli.train_agent --tiny --steps 2 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..env.buffer import TrajectoryBuffer
from ..serve import resolve_device
from ..train.checkpoint import restore_train_checkpoint, save_train_checkpoint
from ..train.metrics import MetricLogger
from ..train.optim import make_lr_schedule
from ..train.train_agent import (create_agent_state, make_ppo_update_step,
                                 make_rollout_fn, make_val_episode_fn)
from ..train.train_geo import make_geo_forward
from ..utils.profiling import trace_context
from .common import (add_common_args, apply_obs_overrides,
                     build_config, build_dataset, load_geo_variables,
                     make_loader, set_seed,
                     tf32_precision, to_device, maybe_initialize_distributed)


def resume_rollout_step(cfg, opt_step: int) -> int:
    """Rollout counter to continue from after ``--resume`` (JAX
    ``cli/train_agent.py:39-54``): the DAgger beta anneal, the rollout
    generators' seeds and checkpoint names follow the rollout counter, and
    the train state counts OPTIMIZER updates, of which each
    ``cfg.num_trajectory`` rollouts flush ``num_trajectory *
    train_batch_size * action_num // ppo_batch_size``."""
    n_flush = cfg.num_trajectory * cfg.train_batch_size * cfg.action_num
    upd_per_flush = max(1, n_flush // cfg.ppo_batch_size)
    return (opt_step + upd_per_flush - 1) // upd_per_flush \
        * cfg.num_trajectory


def agent_updates_per_epoch(cfg, num_batches: int) -> int:
    """Optimizer updates per DATASET epoch, which paces the epoch-granular
    schedule (JAX ``cli/train_agent.py:57-71``; the reference steps its
    scheduler once per dataset epoch, Train_Agent.py:317)."""
    n_flush = cfg.num_trajectory * cfg.train_batch_size * cfg.action_num
    upd_per_flush = n_flush // cfg.ppo_batch_size
    return max(1, max(num_batches, 1) * upd_per_flush
               // max(cfg.num_trajectory, 1))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(p)
    p.add_argument("--geo-ckpt", default="",
                   help="frozen geo checkpoint (a port train checkpoint or "
                        "snapshot, a weight export or the Orbax tree it "
                        "came from); random weights when empty")
    p.add_argument("--resume", default="",
                   help="agent train checkpoint dir to resume from")
    p.add_argument("--reference-reward", action="store_true",
                   help="reproduce the reference's degenerate (constant) "
                        "reward instead of the pose-applied reward")
    p.add_argument("--expert-beta-frac", type=float, default=0.0,
                   help="DAgger scheduled sampling: rollouts take the "
                        "expert action with probability beta annealed "
                        "1->0 over this fraction of the run's ROLLOUT "
                        "steps (loader batches, the --steps unit); 0 = the "
                        "reference's pure on-policy BC")
    p.add_argument("--expert-beta-floor", type=float, default=0.0,
                   help="lower bound on beta: with --expert-beta-frac the "
                        "anneal stops here instead of 0; alone it mixes a "
                        "constant expert fraction into every rollout")
    p.add_argument("--pose-aware", action="store_true",
                   help="pose-aware 3-D observation "
                        "(Config.pose_aware_observation)")
    p.add_argument("--obs-bearing", action="store_true",
                   help="append the overlap-sector bearing as two 3-D "
                        "observation channels (Config.obs_bearing_channels)")
    p.add_argument("--aux-head", action="store_true",
                   help="feed the bearing into the policy/value heads "
                        "(Config.policy_aux_state; implies --obs-bearing)")
    p.add_argument("--bearing-init", action="store_true",
                   help="start every episode from the overlap bearing's yaw "
                        "(Config.bearing_init)")
    p.add_argument("--lr", type=float, default=None, help="override cfg.lr")
    args = p.parse_args(argv)
    maybe_initialize_distributed(args)
    dev = resolve_device(args.device)

    cfg = apply_obs_overrides(build_config(args), args)
    set_seed(cfg.seed)

    train_ds = build_dataset(cfg, args, "train")
    val_ds = build_dataset(cfg, args, "val")
    train_loader = make_loader(cfg, args, train_ds,
                               batch_size=cfg.train_batch_size,
                               shuffle=True, seed=cfg.seed)
    val_loader = make_loader(cfg, args, val_ds,
                             batch_size=cfg.val_batch_size)

    geo = load_geo_variables(cfg, args, dev)
    geo_forward = make_geo_forward(cfg)
    updates_per_epoch = agent_updates_per_epoch(cfg, len(train_loader))
    agent_state = create_agent_state(cfg, dev, seed=cfg.seed,
                                     steps_per_epoch=updates_per_epoch)
    if args.resume:
        agent_state, opt_restored = restore_train_checkpoint(args.resume,
                                                             agent_state)
        print(f"resumed agent from {args.resume} (optimizer state "
              f"{'restored' if opt_restored else 'RESET (model-only)'})")

    rollout = make_rollout_fn(cfg, reward_apply_pose=not args.reference_reward)
    update = make_ppo_update_step(cfg)
    val_episode = make_val_episode_fn(cfg)
    schedule = make_lr_schedule(cfg, updates_per_epoch)

    run_name = f"{args.dataset}_IL_{time.strftime('%m-%d-%H-%M')}"
    logger = MetricLogger(os.path.join(cfg.logdir, run_name))
    ckpt_dir = os.path.abspath(os.path.join(cfg.ckpt_dir, run_name))
    os.makedirs(ckpt_dir, exist_ok=True)

    def run():
        buffer = TrajectoryBuffer(cfg.gamma, cfg.gae_lambda)
        best_r, best_t = np.inf, np.inf
        global_step = resume_rollout_step(cfg, agent_state.step)
        if global_step:
            print(f"resume: continuing at rollout step ~{global_step} "
                  f"(optimizer step {agent_state.step})")
        rng = np.random.default_rng(cfg.seed)

        for epoch in range(cfg.epoch):
            train_loader.set_epoch(epoch)
            for batch in train_loader:
                if args.stop_file and os.path.exists(args.stop_file):
                    logger.flush()
                    save_train_checkpoint(
                        os.path.join(ckpt_dir,
                                     f"stop-epoch-{epoch}-step-{global_step}"),
                        agent_state)
                    print(f"stop-file {args.stop_file} found at step "
                          f"{global_step}; checkpointed and exiting")
                    logger.close()
                    return agent_state
                batch = to_device(batch, dev)

                # validation (Train_Agent.py:170-212)
                if global_step % cfg.val_interval == 0 and len(val_loader):
                    logger.flush()
                    err_t, err_r = [], []
                    for v_batch in val_loader:
                        v_batch = to_device(v_batch, dev)
                        _, rte, rre = val_episode(
                            agent_state, geo_forward(geo, v_batch), v_batch)
                        err_t += rte.tolist()
                        err_r += rre.tolist()
                    new_r, new_t = float(np.mean(err_r)), float(np.mean(err_t))
                    logger.log("val_error/error_r", new_r, global_step)
                    logger.log("val_error/error_t", new_t, global_step)
                    # the reference's gating (Train_Agent.py:204-210): save
                    # when EITHER metric improves, the two bests advancing
                    # independently
                    if new_r < best_r or new_t < best_t:
                        best_r, best_t = min(new_r, best_r), min(new_t, best_t)
                        save_train_checkpoint(
                            os.path.join(ckpt_dir,
                                         f"epoch-{epoch}-step-{global_step}"),
                            agent_state)
                    cur_lr = float(schedule(agent_state.step))
                    logger.log("train/lr", cur_lr, global_step)
                    print(f"[val] step {global_step} RRE {new_r:.3f} "
                          f"RTE {new_t:.3f} lr {cur_lr:.2e} "
                          f"(best {best_r:.3f}/{best_t:.3f})")

                geo_out = geo_forward(geo, batch)
                generator = torch.Generator(device=dev).manual_seed(
                    global_step)
                beta = None
                if args.expert_beta_frac > 0 or args.expert_beta_floor > 0:
                    if args.expert_beta_frac > 0:
                        total = (args.steps if args.steps
                                 else cfg.epoch * max(len(train_loader), 1))
                        ramp = max(1.0, args.expert_beta_frac * total)
                        annealed = 1.0 - global_step / ramp
                    else:     # floor only: constant mixing from step 0
                        annealed = 0.0
                    beta = max(args.expert_beta_floor, annealed)
                traj, _, _ = rollout(agent_state, geo_out, batch, generator,
                                     beta)
                buffer.add(traj)
                logger.log_dict_lazy({"train_loss/reward":
                                      traj["reward"].mean()}, global_step)

                if len(buffer) == cfg.num_trajectory:
                    samples = buffer.samples()
                    n = samples["state_2d"].shape[0]
                    order = rng.permutation(n)
                    bc_losses, ppo_losses = [], []
                    # full minibatches only, as the JAX CLI takes them
                    for s in range(0, n - cfg.ppo_batch_size + 1,
                                   cfg.ppo_batch_size):
                        rows = torch.as_tensor(
                            order[s:s + cfg.ppo_batch_size], device=dev)
                        mb = {k: v.index_select(0, rows)
                              for k, v in samples.items()}
                        metrics = update(agent_state, mb)
                        bc_losses.append(metrics["bc_loss"])
                        ppo_losses.append(metrics["ppo_loss"])
                    if bc_losses:  # the buffer can hold less than a batch
                        logger.log_dict_lazy(
                            {"train_loss/BC_Loss":
                             torch.stack(bc_losses).mean(),
                             "train_loss/PPO_Loss":
                             torch.stack(ppo_losses).mean()}, global_step)
                    buffer.clear()

                global_step += 1
                if args.steps and global_step >= args.steps:
                    print(f"step cap reached ({args.steps})")
                    logger.close()
                    return agent_state
            print(f"epoch {epoch} done")
        logger.close()
        return agent_state

    with trace_context(args.profile), tf32_precision():
        return run()


if __name__ == "__main__":
    main()
