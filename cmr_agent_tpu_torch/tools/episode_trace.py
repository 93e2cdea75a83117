"""Trace-attribute the serving episode: device time by kernel.

Profiles ``--iters`` episodes of the serving workload
(``serve.build_workload`` / ``serve_episode``: geo forward + 10-step
episode, random weights from seed 0, synthetic batch) with
``torch.profiler`` after 3 warm-up episodes, and prints the top device
kernels by total self time — the measurement the kernel-speed work reads
(the JAX package's ``tools/episode_trace.py`` on its xplane).

    python -m cmr_agent_tpu_torch.tools.episode_trace [--batch 8] [--iters 3]

Prints one JSON line ``{total_device_ms_per_iter, wall_ms_per_iter, top:
[{op, total_ms, per_iter_ms, count, pct}], ...}``; diagnostics on stderr.
With ``--device cpu`` (a rehearsal) the rows are the host ops' self time
and ``total_device_ms_per_iter`` is null: nothing ran on a card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import serve
from ..config import kitti_config, micro_config, tiny_config
from ..utils.profiling import profile_device

CONFIGS = {"kitti": kitti_config, "tiny": tiny_config, "micro": micro_config}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--config", default="kitti", choices=sorted(CONFIGS),
                    help="model width (kitti for the measurement; tiny or "
                         "micro for a CPU rehearsal)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for a rehearsal")
    args = ap.parse_args(argv)

    dev = serve.resolve_device(args.device)
    cfg = CONFIGS[args.config](compute_dtype=args.dtype)
    batch, _, _, episode = serve.build_workload(cfg, args.batch, dev, seed=0)
    on_card = dev.type == "cuda"
    log(f"device: {torch.cuda.get_device_name(dev) if on_card else 'cpu'}; "
        f"{args.config} batch {args.batch} {args.dtype}")
    for _ in range(3):
        episode(batch)
    by_op, wall_ms = profile_device(lambda: episode(batch), dev.type,
                                    args.iters)
    total_ms = sum(ms for ms, _ in by_op.values())
    rows = []
    for op, (ms, count) in sorted(by_op.items(),
                                  key=lambda kv: -kv[1][0])[:args.top]:
        rows.append({"op": op[:120], "total_ms": ms,
                     "per_iter_ms": ms / args.iters, "count": count,
                     "pct": 100.0 * ms / max(total_ms, 1e-12)})
        log(f"{rows[-1]['per_iter_ms']:9.3f} ms/iter {rows[-1]['pct']:5.1f}%"
            f"  x{count:<5d} {op[:100]}")
    log(f"total {'device' if on_card else 'host op'} self time: "
        f"{total_ms / args.iters:.2f} ms/iter over {args.iters} iters; wall "
        f"{wall_ms / args.iters:.2f} ms/iter (profiled)")
    result = {
        "total_device_ms_per_iter": total_ms / args.iters if on_card else None,
        "wall_ms_per_iter": wall_ms / args.iters,
        "top": rows,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "config": args.config, "batch": args.batch, "dtype": args.dtype,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
