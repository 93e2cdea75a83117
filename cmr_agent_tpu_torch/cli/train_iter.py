"""Train the IterModel cost-volume pose head against a frozen geo model
(counterpart of the JAX package's ``cli/train_iter.py``; the reference
ships IterModel's loss but no training script, models/IterModel.py:31-35,
174-192).

Geo forward (frozen) -> cost-volume forward / backward on the hypothesis
grid's labels -> checkpoints when the validation loss improves, and always
at the step cap.

Usage::

    python -m cmr_agent_tpu_torch.cli.train_iter --dataset synthetic \\
        --steps 10 --synthetic-length 16 [--remat]
    python -m cmr_agent_tpu_torch.cli.train_iter --tiny --steps 3 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..serve import resolve_device
from ..train.checkpoint import restore_train_checkpoint, save_train_checkpoint
from ..train.optim import make_lr_schedule
from ..train.train_geo import make_geo_forward
from ..train.train_iter import (cost_volume_metrics, create_iter_state,
                                iter_model_state, make_iter_train_step)
from ..utils.profiling import trace_context
from .common import (add_common_args, apply_obs_overrides,
                     build_config, build_dataset, load_geo_variables,
                     make_loader, refuse_bf16_training, set_seed,
                     tf32_precision, to_device, maybe_initialize_distributed)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(p)
    p.add_argument("--geo-ckpt", default="",
                   help="frozen geo checkpoint (a weight export or the Orbax "
                        "tree it came from); random weights when empty")
    p.add_argument("--val-interval", type=int, default=0,
                   help="steps between validations (0 = config default)")
    p.add_argument("--resume", default="",
                   help="IterModel train checkpoint dir to resume from "
                        "(model + optimizer state)")
    p.add_argument("--unmasked-warp", action="store_true",
                   help="warp ALL points instead of the predicted-overlap "
                        "subset (Config.cost_volume_unmasked)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the cost volume and the tower's first "
                        "stage in the backward (Config.cost_volume_remat): "
                        "more step time for less activation memory")
    args = p.parse_args(argv)
    maybe_initialize_distributed(args)
    dev = resolve_device(args.device)

    cfg = apply_obs_overrides(build_config(args), args)
    refuse_bf16_training(cfg)
    set_seed(cfg.seed)
    val_interval = args.val_interval or cfg.val_interval

    train_ds = build_dataset(cfg, args, "train")
    val_ds = build_dataset(cfg, args, "val")
    loader = make_loader(cfg, args, train_ds,
                         batch_size=cfg.train_batch_size,
                         shuffle=True, seed=cfg.seed)
    val_loader = make_loader(cfg, args, val_ds,
                             batch_size=cfg.val_batch_size)

    geo = load_geo_variables(cfg, args, dev)
    geo_forward = make_geo_forward(cfg)
    steps_per_epoch = max(1, len(loader))
    iter_state = create_iter_state(cfg, dev, seed=cfg.seed,
                                   steps_per_epoch=steps_per_epoch)
    if args.resume:
        iter_state, opt_restored = restore_train_checkpoint(args.resume,
                                                            iter_state)
        print(f"resumed IterModel from {args.resume} (optimizer state "
              f"{'restored' if opt_restored else 'RESET (model-only)'})")
    step_fn = make_iter_train_step(cfg)
    schedule = make_lr_schedule(cfg, steps_per_epoch)

    ckpt_root = os.path.join(cfg.ckpt_dir, f"iter_{cfg.name}")
    best_loss = float("inf")
    # continue the counter from the restored optimizer step, so checkpoint
    # names do not collide with the interrupted run's and --steps caps the
    # TOTAL steps across resumes
    step = iter_state.step

    def validate():
        model = iter_state.model.eval()
        rows = []
        with torch.no_grad():
            for vb in val_loader:
                vb = to_device(vb, dev)
                st = iter_model_state(geo_forward(geo, vb), vb)
                rows.append({k: float(v) for k, v in cost_volume_metrics(
                    cfg, model(st, with_loss=True)).items()})
        return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}

    def run():
        nonlocal step, best_loss
        for epoch in range(cfg.epoch):
            loader.set_epoch(epoch)
            for batch in loader:
                if args.stop_file and os.path.exists(args.stop_file):
                    save_train_checkpoint(
                        os.path.join(ckpt_root,
                                     f"stop-epoch-{epoch}-step-{step}"),
                        iter_state)
                    print(f"stop-file {args.stop_file} found at step {step}; "
                          f"checkpointed and exiting", flush=True)
                    return iter_state
                batch = to_device(batch, dev)
                st = iter_model_state(geo_forward(geo, batch), batch)
                metrics = step_fn(iter_state, st)

                if step % val_interval == 0 and len(val_loader):
                    v = validate()
                    improved = v["cost_volume_loss"] < best_loss
                    best_loss = min(best_loss, v["cost_volume_loss"])
                    cur_lr = float(schedule(iter_state.step))
                    print(f"[val] step {step} cv_loss "
                          f"{v['cost_volume_loss']:.4f} "
                          f"grid_acc {v['grid_accuracy']:.3f} "
                          f"ry/tx/tz {v['acc_ry']:.3f}/{v['acc_tx']:.3f}/"
                          f"{v['acc_tz']:.3f} "
                          f"1bin {v['acc_ry_1bin']:.3f}/"
                          f"{v['acc_tx_1bin']:.3f}/{v['acc_tz_1bin']:.3f} "
                          f"lr {cur_lr:.2e} (best {best_loss:.4f})",
                          flush=True)
                    if improved:
                        save_train_checkpoint(
                            os.path.join(ckpt_root,
                                         f"epoch-{epoch}-step-{step}"),
                            iter_state)
                step += 1
                if args.steps and step >= args.steps:
                    # always save the final state: the flagship evaluation
                    # composes from the last checkpoint, not the best
                    # validation loss
                    save_train_checkpoint(
                        os.path.join(ckpt_root, f"epoch-{epoch}-step-{step}"),
                        iter_state)
                    print(f"step cap reached ({args.steps}); final cv_loss "
                          f"{float(metrics['cost_volume_loss']):.4f}; "
                          f"saved final checkpoint at step {step}",
                          flush=True)
                    return iter_state
            print(f"epoch {epoch} done", flush=True)
        save_train_checkpoint(
            os.path.join(ckpt_root, f"final-step-{step}"), iter_state)
        return iter_state

    with trace_context(args.profile), tf32_precision():
        return run()


if __name__ == "__main__":
    main()
