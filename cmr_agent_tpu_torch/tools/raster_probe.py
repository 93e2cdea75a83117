"""Observation-raster kernel probe: the port's image-raster kernels at the
episode's shapes, each timed on the card.

The cases (the JAX package's ``tools/raster_probe.py`` matrix):

  base    ``kernels.segment_mean_count`` — the generic segment sum
          (kernel 5) of the rows with a ones column;
  flat    ``kernels.segment_mean_count_image`` — the pixel-id raster
          (kernel 6a), counts in the kernel [f32 | bf16];
  fact    ``segment_mean_count_image(factored=True)`` — the factored
          raster (kernel 6b): on the card the flat case's band kernel,
          writing means and counts (the flat case's bits, no ones column
          copied); on the CPU the plain version of the rows with a ones
          column [f32 | bf16];
  comp    ``kernels.segment_sum_count_image_compact`` — the compacting
          raster (kernel 8: the band kernel writing sums, each band
          listing its landing rows from all ids) [f32 | bf16]; measure
          with ``--scattered`` for the per-step pose-dependent validity a
          global top-K cannot compact.

``--valid-frac`` emulates the compacted episode's layout: the leading
fraction of each sample's rows lands in the frame, the tail is routed out
(id ``h*w``). The JAX probe's ``--tile`` (the Pallas point-tile size) has
no meaning for these kernels and is not taken. Run on the card::

    python -m cmr_agent_tpu_torch.tools.raster_probe [--valid-frac 0.25]

Times are CUDA events around ``--iters`` calls after 3 warm-up calls; with
``--device cpu`` (a rehearsal) they are the host clock's and the JSON says
so. Prints one JSON line (``<case>_ms``, ``best``,
``best_speedup_vs_base``, ``valid_frac``, ``device``); diagnostics on
stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import serve
from ..ops import kernels
from ..utils.profiling import cuda_ms


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def host_ms(fn, iters: int) -> float:
    """Mean host-clock time of ``fn`` per call after 3 warm-up calls (the
    CPU rehearsal's)."""
    for _ in range(3):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def make_inputs(batch: int, n: int, f: int, h: int, w: int,
                valid_frac: float, scattered: bool, device):
    """``(feat [B,N,F] f32, ids [B,N] int32)`` from numpy seed 0, as the JAX
    probe makes them: valid rows first (or, with ``scattered``, at random
    positions), each with a uniform pixel id; the rest routed out."""
    rng = np.random.default_rng(0)
    m = h * w
    n_valid = int(n * valid_frac)
    ids = np.full((batch, n), m, np.int32)
    if scattered:
        for b in range(batch):
            sel = rng.choice(n, size=n_valid, replace=False)
            ids[b, sel] = rng.integers(0, m, size=n_valid)
    else:
        ids[:, :n_valid] = rng.integers(0, m, size=(batch, n_valid))
    feat = rng.normal(size=(batch, n, f)).astype(np.float32)
    return (torch.from_numpy(feat).to(device),
            torch.from_numpy(ids).to(device))


def cases(h: int, w: int):
    """``{name: fn(feat, ids) -> means}`` for the seven cases."""
    m = h * w
    bf16 = torch.bfloat16

    def image(dtype, factored):
        return lambda f_, i_: kernels.segment_mean_count_image(
            f_, i_, h, w, dtype, factored=factored)[0]

    def compact(dtype):
        def fn(f_, i_):
            sums, counts = kernels.segment_sum_count_image_compact(
                f_, i_, h, w, dtype)
            return sums / counts.clamp_min(1.0)[..., None]
        return fn

    return {
        "base": lambda f_, i_: kernels.segment_mean_count(f_, i_, m)[0],
        "flat_f32": image(None, False),
        "flat_bf16": image(bf16, False),
        "fact_f32": image(None, True),
        "fact_bf16": image(bf16, True),
        "comp_f32": compact(None),
        "comp_bf16": compact(bf16),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n", type=int, default=20480,
                   help="points after top-K compaction (cfg.raster_topk)")
    p.add_argument("--f", type=int, default=64)
    p.add_argument("--h", type=int, default=40)
    p.add_argument("--w", type=int, default=128)
    p.add_argument("--valid-frac", type=float, default=1.0,
                   help="leading fraction of points with in-image ids; the "
                        "tail is routed out (the compacted-episode layout)")
    p.add_argument("--scattered", action="store_true",
                   help="scatter the valid points uniformly instead of "
                        "valid-first (the uncompacted per-step layout)")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for a rehearsal")
    args = p.parse_args(argv)

    dev = serve.resolve_device(args.device)
    feat, ids = make_inputs(args.batch, args.n, args.f, args.h, args.w,
                            args.valid_frac, args.scattered, dev)
    on_card = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    n_valid = int(((ids >= 0) & (ids < args.h * args.w)).sum().item())
    log(f"device: {name!r}; feat {tuple(feat.shape)}; m={args.h * args.w} "
        f"valid={n_valid}/{args.batch * args.n} scattered={args.scattered}")

    ms = {}
    with torch.inference_mode():
        for case, fn in cases(args.h, args.w).items():
            call = (lambda fn=fn: fn(feat, ids))
            ms[case] = (cuda_ms(call, args.iters) if on_card
                        else host_ms(call, args.iters))
            log(f"{case:10s} {ms[case]:9.4f} ms/call")

    best = min(ms, key=ms.get)
    result = {
        **{f"{k}_ms": v for k, v in ms.items()},
        "best": best,
        "best_speedup_vs_base": ms["base"] / ms[best],
        "valid_frac": args.valid_frac,
        "scattered": args.scattered,
        "device": name,
        "timed_by": "cuda events" if on_card else "host clock",
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
