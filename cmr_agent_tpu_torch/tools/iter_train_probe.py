"""The IterModel train step's time and peak memory, with and without
remat, in a process of its own.

For each mode (``plain``; ``remat``, ``Config.cost_volume_remat``): a fresh
``IterModel`` (random weights from seed 0) on the frozen outputs of a random
geo model over the synthetic batch, ``--steps`` train steps
(``train.train_iter.make_iter_train_step``), each between two
synchronisations, the first a warm-up; the peak memory of the steps
(``max_memory_allocated`` after a reset) and what the caching allocator
held after them (``memory_reserved``). A mode that runs out of memory
reports ``"OOM"``. ``--tf32 on`` runs the f32 matmuls and convolutions
at TF32, as the training CLIs do (:func:`..cli.common.tf32_precision`);
``off`` in full f32.

    python -m cmr_agent_tpu_torch.tools.iter_train_probe [--batch 8]
        [--steps 4] [--modes plain,remat] [--tf32 on|off]

Prints one JSON line ``{modes: {mode: {step_ms, median_ms, peak_gib,
reserved_gib} | "OOM"}, batch, config, tf32, device}``. With ``--device
cpu`` (a rehearsal) the times are the CPU's and no memory is reported.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import time

import torch

from .. import serve
from ..cli.common import tf32_precision
from ..config import kitti_config, micro_config, tiny_config
from ..train.train_geo import create_geo_state, make_geo_forward
from ..train.train_iter import (create_iter_state, iter_model_state,
                                make_iter_train_step)
from ..utils.profiling import device_sync

CONFIGS = {"kitti": kitti_config, "tiny": tiny_config, "micro": micro_config}
KEYS = serve.BATCH_KEYS + ("R_amplitude", "T_amplitude", "label_R",
                           "label_T_x", "label_T_z")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--modes", default="plain,remat")
    ap.add_argument("--tf32", choices=("on", "off"), default="on",
                    help="TF32 matmuls and convolutions, as the training "
                         "CLIs run them (on), or full f32 (off)")
    ap.add_argument("--config", default="kitti", choices=sorted(CONFIGS),
                    help="model width (kitti for the measurement; tiny or "
                         "micro for a CPU rehearsal)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for a rehearsal")
    args = ap.parse_args(argv)
    with tf32_precision(args.tf32 == "on"):
        return run(args)


def run(args) -> dict:
    dev = serve.resolve_device(args.device)
    cuda = dev.type == "cuda"
    cfg = CONFIGS[args.config]()
    batch = serve.synthetic_batch(cfg, args.batch, dev, seed=0, keys=KEYS)
    geo = create_geo_state(cfg, dev, seed=0).model
    st = iter_model_state(make_geo_forward(cfg)(geo, batch), batch)
    del geo

    modes = {}
    for mode in args.modes.split(","):
        c = dataclasses.replace(cfg, cost_volume_remat=mode == "remat")
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        state = create_iter_state(c, dev, seed=0)
        step = make_iter_train_step(c)
        times = []
        try:
            for _ in range(args.steps):
                device_sync(dev)
                t0 = time.perf_counter()
                step(state, st)
                device_sync(dev)
                times.append((time.perf_counter() - t0) * 1e3)
        except torch.OutOfMemoryError:
            modes[mode] = "OOM"
            continue
        finally:
            del state, step
        row = {"step_ms": [round(t, 2) for t in times],
               "median_ms": round(statistics.median(times[1:] or times), 2)}
        if cuda:
            row["peak_gib"] = round(torch.cuda.max_memory_allocated(dev)
                                    / 2**30, 3)
            row["reserved_gib"] = round(torch.cuda.memory_reserved(dev)
                                        / 2**30, 3)
        modes[mode] = row
    result = {"modes": modes, "batch": args.batch, "config": args.config,
              "tf32": args.tf32,
              "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
