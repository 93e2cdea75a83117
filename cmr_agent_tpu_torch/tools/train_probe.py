"""Attribute the geo train step's host residue: the same step under five
loop variants.

Times the port's geo train step (``train.train_geo.create_geo_state`` /
``make_geo_train_step``, random weights from seed 0, the synthetic batch,
dropout on) for ``--steps`` steps per variant, each run ending in one
synchronisation, so that each suspect of the host side is measured, not
guessed (the JAX package's ``tools/train_probe.py``). The variants take
two turns, the second in reverse order, so that a drift over the run falls
on all of them alike; the mean of the two is reported:

  pure     the loop carries only the state; one sync at the end. The floor.
  lazylog  + keep every step's metrics tensors alive (a logger that buffers
           them).
  sync     + ``.item()`` of the loss every step (the worst readback pattern).
  hostrng  + a fresh ``torch.Generator`` for the dropout masks every step,
           seeded from a host RNG.
  feed     + a fresh host (numpy) batch copied to the device every step (the
           input path a loader pays).

    python -m cmr_agent_tpu_torch.tools.train_probe [--batch 8] [--steps 30]

``--dtype bfloat16`` times the bf16 step (the JAX tool's default; this
tool keeps float32, the dtype chip_smoke.py times it in).
Prints one JSON line ``{ms_per_step: {variant: ms}, residue_vs_pure_ms,
batch, dtype, device}``; diagnostics on stderr. With ``--device cpu`` (a
rehearsal) the times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import serve
from ..config import kitti_config, micro_config, tiny_config
from ..train.train_geo import create_geo_state, make_geo_train_step
from ..utils.profiling import device_sync

CONFIGS = {"kitti": kitti_config, "tiny": tiny_config, "micro": micro_config}
ROUNDS = 2


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--config", default="kitti", choices=sorted(CONFIGS),
                    help="model width (kitti for the measurement; tiny or "
                         "micro for a CPU rehearsal)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for a rehearsal")
    args = ap.parse_args(argv)

    dev = serve.resolve_device(args.device)
    cfg = CONFIGS[args.config](compute_dtype=args.dtype)
    host_batch = serve.synthetic_batch(cfg, args.batch, "cpu", seed=0,
                                       keys=serve.TRAIN_KEYS)
    host_np = {k: v.numpy() for k, v in host_batch.items()}
    batch = {k: v.to(dev) for k, v in host_batch.items()}
    state = create_geo_state(cfg, dev, seed=0)
    step = make_geo_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name}; {args.config} batch {args.batch} {args.dtype}")

    t0 = time.perf_counter()
    step(state, batch, gen)
    device_sync(dev)
    log(f"first step {time.perf_counter() - t0:.1f}s")
    for _ in range(3):
        step(state, batch, gen)
    device_sync(dev)

    def pure():
        m = None
        for _ in range(args.steps):
            m = step(state, batch, gen)
        return m

    def lazylog():
        kept = []
        for _ in range(args.steps):
            kept.append(step(state, batch, gen))
        return kept[-1]

    def sync():
        total = 0.0
        m = None
        for _ in range(args.steps):
            m = step(state, batch, gen)
            total += m["loss"].item()
        return m

    def hostrng():
        host = np.random.default_rng(0)
        m = None
        for _ in range(args.steps):
            g = torch.Generator(device=dev).manual_seed(
                int(host.integers(2**62)))
            m = step(state, batch, g)
        return m

    def feed():
        m = None
        for _ in range(args.steps):
            b = {k: torch.from_numpy(v).to(dev) for k, v in host_np.items()}
            m = step(state, b, gen)
        return m

    variants = (pure, lazylog, sync, hostrng, feed)
    times = {v.__name__: [] for v in variants}
    for r in range(ROUNDS):            # in turns: forward, then backward
        for variant in (variants if r % 2 == 0 else variants[::-1]):
            device_sync(dev)
            t0 = time.perf_counter()
            m = variant()
            m["loss"].item()     # a readback: the last step has finished
            times[variant.__name__].append(
                (time.perf_counter() - t0) * 1e3 / args.steps)
    results = {k: sum(v) / len(v) for k, v in times.items()}
    for k, v in times.items():
        log(f"{k:10s} {results[k]:9.2f} ms/step  (rounds: "
            + ", ".join(f"{t:.2f}" for t in v) + ")")
    base = results["pure"]
    result = {"ms_per_step": results,
              "residue_vs_pure_ms": {k: v - base for k, v in results.items()
                                     if k != "pure"},
              "batch": args.batch, "dtype": args.dtype, "device": name,
              "config": args.config}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
