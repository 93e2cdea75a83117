"""Train the one-shot geo model (counterpart of the JAX package's
``cli/train_geo.py``; reference Train_Geo.py).

Usage::

    python -m cmr_agent_tpu_torch.cli.train_geo --dataset synthetic --steps 8
    python -m cmr_agent_tpu_torch.cli.train_geo --tiny --steps 5 --device cpu

Each step is :func:`..train.train_geo.make_geo_train_step`; with
``--steps-per-dispatch S`` (S > 1) the steps go ``S`` at a time through
:func:`..train.train_geo.make_geo_multi_step`, on the card one captured
CUDA graph replayed per step. Dropout draws from one generator on the
device, seeded with the step the run starts at (the JAX CLI keys each
step's dropout with its step number).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..serve import resolve_device
from ..train.checkpoint import restore_train_checkpoint, save_train_checkpoint
from ..train.metrics import MetricLogger
from ..train.optim import make_lr_schedule
from ..train.train_geo import (create_geo_state, make_geo_eval_step,
                               make_geo_multi_step, make_geo_train_step)
from ..utils.profiling import trace_context
from .common import (add_common_args, build_config, build_dataset,
                     make_loader, set_seed,
                     tf32_precision, to_device, maybe_initialize_distributed)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(p)
    p.add_argument("--resume", default="",
                   help="train checkpoint dir to resume the model, the "
                        "optimizer and the step from")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="optimiser steps per call of the multi-step (on the "
                        "card one CUDA graph replayed per step). The step "
                        "cap / val interval round up to a multiple; at most "
                        "S-1 tail batches per epoch are dropped (drop_last "
                        "semantics).")
    args = p.parse_args(argv)
    maybe_initialize_distributed(args)
    dev = resolve_device(args.device)

    cfg = build_config(args)
    set_seed(cfg.seed)

    train_ds = build_dataset(cfg, args, "train")
    val_ds = build_dataset(cfg, args, "val")
    train_loader = make_loader(cfg, args, train_ds,
                               batch_size=cfg.train_batch_size,
                               shuffle=True, seed=cfg.seed)
    val_loader = make_loader(cfg, args, val_ds,
                             batch_size=cfg.val_batch_size)

    steps_per_epoch = max(len(train_loader), 1)
    state = create_geo_state(cfg, dev, seed=cfg.seed,
                             steps_per_epoch=steps_per_epoch)
    if args.resume:
        state, opt_restored = restore_train_checkpoint(args.resume, state)
        opt_msg = ("restored" if opt_restored else
                   "RESET — model-only checkpoint; Adam moments start "
                   "fresh, the schedule at the restored step")
        print(f"resumed from {args.resume} at step {state.step} "
              f"(optimizer state {opt_msg})")
    dispatch = max(1, args.steps_per_dispatch)
    if dispatch > 1:
        train_step_multi = make_geo_multi_step(cfg, dispatch)
    else:
        train_step = make_geo_train_step(cfg)
    eval_step = make_geo_eval_step(cfg)
    schedule = make_lr_schedule(cfg, steps_per_epoch)

    run_name = f"{args.dataset}_{cfg.num_pt}_{time.strftime('%m-%d-%H-%M')}"
    logger = MetricLogger(os.path.join(cfg.logdir, run_name))
    ckpt_dir = os.path.abspath(os.path.join(cfg.ckpt_dir, run_name))
    os.makedirs(ckpt_dir, exist_ok=True)

    def run():
        microbatches = []
        # continue from the restored step on --resume, so checkpoint names
        # do not collide with the interrupted run's and --steps caps the
        # TOTAL steps across resumes (the schedule continues via the
        # optimizer's count)
        global_step, best_loss = state.step, float("inf")
        generator = torch.Generator(device=dev).manual_seed(global_step)
        for epoch in range(cfg.epoch):
            train_loader.set_epoch(epoch)
            for batch in train_loader:
                if args.stop_file and os.path.exists(args.stop_file):
                    logger.flush()
                    save_train_checkpoint(
                        os.path.join(ckpt_dir,
                                     f"stop-epoch-{epoch}-step-{global_step}"),
                        state)
                    print(f"stop-file {args.stop_file} found at step "
                          f"{global_step}; checkpointed and exiting")
                    logger.close()
                    return state
                if (global_step % cfg.val_interval < dispatch
                        and not microbatches and len(val_loader)):
                    logger.flush()
                    val_metrics = []
                    for v_batch in val_loader:
                        v_batch = to_device(v_batch, dev)
                        val_metrics.append({
                            k: float(v) for k, v in
                            eval_step(state, v_batch).items()})
                    mean = {k: float(np.mean([m[k] for m in val_metrics]))
                            for k in val_metrics[0]}
                    logger.log_dict(mean, global_step, prefix="val/")
                    # save only on improvement, as the reference does
                    # (Train_Geo.py:156-163)
                    if np.isfinite(mean["loss"]) and mean["loss"] < best_loss:
                        best_loss = mean["loss"]
                        save_train_checkpoint(
                            os.path.join(ckpt_dir,
                                         f"epoch-{epoch}-step-{global_step}"),
                            state)
                    cur_lr = float(schedule(state.step))
                    logger.log("train/lr", cur_lr, global_step)
                    print(f"[val] step {global_step} loss {mean['loss']:.4f} "
                          f"lr {cur_lr:.2e} (best {best_loss:.4f})")

                batch = to_device(batch, dev)
                if dispatch > 1:
                    microbatches.append(batch)
                    if len(microbatches) < dispatch:
                        continue
                    stacked = {k: torch.stack([mb[k] for mb in microbatches])
                               for k in batch}
                    microbatches.clear()
                    metrics = train_step_multi(state, stacked, generator)
                    logger.log_dict_lazy(metrics, global_step,
                                         prefix="train/", steps_axis=True)
                    metrics = {k: v[-1] for k, v in metrics.items()}
                    global_step += dispatch
                else:
                    metrics = train_step(state, batch, generator)
                    logger.log_dict_lazy(metrics, global_step,
                                         prefix="train/")
                    global_step += 1
                if args.steps and global_step >= args.steps:
                    logger.flush()
                    print(f"step cap reached ({args.steps}); final loss "
                          f"{float(metrics['loss']):.4f}")
                    logger.close()
                    return state
            # a partial accumulation never spans epochs: the tail (at most
            # dispatch-1 batches, as the loader's drop_last) is dropped so
            # that one multi-step never mixes epoch streams
            microbatches.clear()
            print(f"epoch {epoch} done")
        logger.close()
        return state

    with trace_context(args.profile), tf32_precision():
        return run()


if __name__ == "__main__":
    main()
