"""Dataset smoke / stress harness (the port's copy of the JAX package's
``data/smoke.py``; reference dataset/KittiDataset.py:426-461: a
single-sample pull and a multi-worker full-dataset stress reader)::

    python -m cmr_agent_tpu_torch.data.smoke --dataset synthetic --tiny
    python -m cmr_agent_tpu_torch.data.smoke --dataset kitti \\
        --data-root ... --stress --workers 8
    python -m cmr_agent_tpu_torch.data.smoke --dataset nuscenes \\
        --data-root ... --feed-rate 20

``--feed-rate NBATCH`` times the training CLIs' loader (``make_loader``'s
worker count and backend, ``--num-workers`` / ``--loader-backend``) over
at most NBATCH batches of one epoch after a warm-up batch; ``main``
returns the samples/s. Host only: no model, no device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import time

import numpy as np

from ..cli.common import add_common_args, build_config, build_dataset


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(p)
    p.add_argument("--mode", default="train",
                   choices=["train", "val", "test"])
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--stress", action="store_true",
                   help="read the whole dataset with a thread pool")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--feed-rate", type=int, default=0, metavar="NBATCH",
                   help="measure the training-CLI loader feed rate over "
                        "NBATCH batches (uses the same make_loader policy "
                        "as the train CLIs: --num-workers/--loader-backend "
                        "apply)")
    args = p.parse_args(argv)

    cfg = build_config(args)
    ds = build_dataset(cfg, args, args.mode)
    print(f"{len(ds)} samples in {args.mode} set")

    t0 = time.perf_counter()
    sample = ds[args.index]
    dt = time.perf_counter() - t0
    print(f"sample[{args.index}] in {dt*1e3:.1f} ms:")
    for k, v in sample.items():
        v = np.asarray(v)
        print(f"  {k:32s} {str(v.shape):18s} {v.dtype}")

    if args.feed_rate:
        from ..cli.common import make_loader
        loader = make_loader(cfg, args, ds,
                             batch_size=cfg.train_batch_size,
                             shuffle=True, seed=cfg.seed)
        backend = ("sync" if loader.num_workers == 0 else
                   "processes" if loader.use_processes else "threads")
        print(f"loader: {loader.num_workers} workers ({backend}), "
              f"batch {cfg.train_batch_size}")
        if len(loader) == 0:
            raise SystemExit(
                f"dataset ({len(ds)} samples) is smaller than one batch "
                f"({cfg.train_batch_size}, drop_last) — nothing to time")
        it = iter(loader)
        next(it)  # warm-up: pool spin-up + first pipeline pass
        t0 = time.perf_counter()
        done = 0
        for done, _ in enumerate(it, start=1):
            if done >= args.feed_rate:
                break
        dt = time.perf_counter() - t0
        rate = done * cfg.train_batch_size / dt
        print(f"feed rate: {rate:.1f} samples/s "
              f"({done} batches in {dt:.1f} s)")
        loader.close()
        return rate

    if args.stress:
        n = len(ds)
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(args.workers) as ex:
            for i, _ in enumerate(ex.map(ds.__getitem__, range(n))):
                if (i + 1) % 50 == 0:
                    rate = (i + 1) / (time.perf_counter() - t0)
                    print(f"  {i+1}/{n}  {rate:.1f} samples/s", flush=True)
        print(f"stress done: {n / (time.perf_counter()-t0):.1f} samples/s")


if __name__ == "__main__":
    main()
