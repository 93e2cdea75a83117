"""The two segment sums (kernels 5 and 7) timed alone, at the shapes their
checks use and on the calls their paths make, one tree of the port per
process, so that two trees can be compared in turns on one card.

  uniform  kernel 5 at the geo model's three shapes (points -> nodes, the
           knn neighbourhoods -> nodes, nodes -> proxies; F = embed_dim)
           on uniform ids, and kernel 7 at one eval chunk of the cost
           volume's warp (``--hypotheses`` maps of the top-K rows into the
           image's pixels, 40% of the rows landing, hypothesis 1 seeing
           none);
  geo      kernel 5 on each of its calls in one geo train step (random
           weights and the synthetic batch from seed 0; the gathers'
           gradients and their ids, captured);
  request  kernel 7 on each of its calls in one composed request at the
           flagship options (f32), and kernel 7's device time in the whole
           request (``--skip-request`` leaves this part out).

A row holds the wrapper's ms (CUDA events around repeated calls), the
device ms of every kernel whose name contains "segment" (``torch.profiler``,
by name), whether two launches gave the same bits, how the ids spread
(rows landing, most rows on one segment) and, for kernel 5, the ms of one
``scatter_add_`` into a zeroed output with the index prepared. The tool
imports the tree it runs from, so to time another tree (a parent's), copy
this file into that tree's ``cmr_agent_tpu_torch/tools/`` and run it from
that tree's root::

    python -m cmr_agent_tpu_torch.tools.segment_turns [--tag NAME]

Prints one JSON line per row and, last, one with the totals per part;
diagnostics on stderr. With ``--device cpu --config micro`` a rehearsal at
a small size: the wrappers run their plain versions, times come from the
host clock and device times are null.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .. import serve
from ..config import kitti_config, micro_config, tiny_config
from ..ops import kernels
from ..utils.profiling import cuda_ms, device_sync, profile_device

CONFIGS = {"kitti": kitti_config, "tiny": tiny_config, "micro": micro_config}
# the flagship setting of the composed request (runs_r5/README.md, E7)
FLAGSHIP_CFG = dict(cost_volume_unmasked=True, pose_aware_observation=True,
                    obs_bearing_channels=True, policy_aux_state=True,
                    bearing_init=True)
FLAGSHIP_OPTS = dict(hypotheses=13, iter_iters=2, refine_rounds=1,
                     refine_beam=("combo", "mean_valid", "ir_smooth"),
                     beam_score="above50_norm", hypo_score="combo")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def capture(name: str, fn):
    """Runs ``fn()`` with ``kernels.<name>`` recording copies of its
    arguments ``(data, idx, num_segments)``; returns them in call order."""
    calls = []
    wrapper = getattr(kernels, name)

    def record(data, idx, m):
        calls.append((data.detach().clone(), idx.clone(), int(m)))
        return wrapper(data, idx, m)
    # the wrapper counts its launches on the module's attribute
    record.launches = wrapper.launches
    setattr(kernels, name, record)
    try:
        fn()
    finally:
        wrapper.launches = record.launches
        setattr(kernels, name, wrapper)
    return calls


def wall_ms(fn, iters: int, dev: torch.device) -> float:
    """ms per call: CUDA events on the card, the host clock on the CPU."""
    if dev.type == "cuda":
        return cuda_ms(fn, iters)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def device_ms_by_name(fn, dev: torch.device, iters: int):
    """Device ms per call of each kernel whose name holds "segment"; None
    on the CPU."""
    if dev.type != "cuda":
        return None
    fn()
    by_name, _ = profile_device(fn, iters=iters)
    return {k[:60]: t / iters for k, (t, _) in by_name.items()
            if "segment" in k}


def spread(idx: torch.Tensor, m: int) -> dict:
    flat = idx.reshape(-1, idx.shape[-1]).long()
    valid = (flat >= 0) & (flat < m)
    counts = torch.zeros(flat.shape[0], m + 1, dtype=torch.long,
                         device=flat.device).scatter_add_(
        1, torch.where(valid, flat, m), torch.ones_like(flat))[:, :m]
    return dict(rows_landing=int(valid.sum()),
                max_rows_on_a_segment=int(counts.max()))


def row(part: str, name: str, data, idx, m: int, dev, iters: int) -> dict:
    fn = getattr(kernels, name)
    first = fn(data, idx, m)
    out = dict(part=part, kernel=name, shape=[list(data.shape),
                                              list(idx.shape), m],
               same_bits=bool(torch.equal(fn(data, idx, m), first)),
               **spread(idx, m))
    del first
    out["ms"] = wall_ms(lambda: fn(data, idx, m), iters, dev)
    out["device_ms"] = device_ms_by_name(lambda: fn(data, idx, m), dev,
                                         max(1, iters // 4))
    if name == "segment_sum":
        b, n, f = data.shape
        seg = torch.where((idx >= 0) & (idx < m), idx, m).long()
        seg = seg[..., None].expand(b, n, f)
        out["scatter_add_ms"] = wall_ms(
            lambda: torch.zeros(b, m + 1, f, device=dev).scatter_add_(
                1, seg, data), iters, dev)
    print(json.dumps(out), flush=True)
    return out


def total(rows, part: str) -> dict:
    picked = [r for r in rows if r["part"] == part]
    out = dict(calls=len(picked), ms=sum(r["ms"] for r in picked),
               same_bits=all(r["same_bits"] for r in picked))
    if picked and picked[0]["device_ms"] is not None:
        out["device_ms"] = sum(sum(r["device_ms"].values()) for r in picked)
    if picked and "scatter_add_ms" in picked[0]:
        out["scatter_add_ms"] = sum(r["scatter_add_ms"] for r in picked)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--hypotheses", type=int, default=243,
                    help="maps of kernel 7's uniform case (an eval chunk)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--config", default="kitti", choices=sorted(CONFIGS),
                    help="model width (kitti for the measurement; tiny or "
                         "micro for a CPU rehearsal)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for a rehearsal")
    ap.add_argument("--skip-request", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    dev = serve.resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        kernels.library()
        log(f"device: {torch.cuda.get_device_name(dev)}; kernels built in "
            f"{time.perf_counter() - t0:.1f}s")
    cfg = CONFIGS[args.config]()
    b, f = args.batch, cfg.embed_dim
    gen = torch.Generator().manual_seed(4321)
    rows = []

    def draw(n, m, width, *maps):
        data = torch.randn(b, n, width, generator=gen).to(dev)
        idx = torch.randint(0, m, (b, *maps, n), generator=gen,
                            dtype=torch.int32).to(dev)
        return data, idx

    for n, m in ((cfg.num_pt, cfg.num_node),
                 (cfg.num_node * cfg.knn_k, cfg.num_node),
                 (cfg.num_node, cfg.num_proxy)):
        data, idx = draw(n, m, f)
        rows.append(row("uniform", "segment_sum", data, idx, m, dev,
                        args.iters))
    npix, warp_k = cfg.image_h * cfg.image_w, min(8192, cfg.num_pt)
    data, idx = draw(warp_k, int(npix * 2.5), f + 2, args.hypotheses)
    idx[:, 1] = npix
    rows.append(row("uniform", "segment_sum_shared", data, idx, npix, dev,
                    max(2, args.iters // 4)))
    del data, idx

    from ..train.train_geo import create_geo_state, make_geo_train_step
    batch = serve.synthetic_batch(cfg, b, dev, seed=0, keys=serve.TRAIN_KEYS)
    state = create_geo_state(cfg, dev, seed=0)
    step = make_geo_train_step(cfg)
    step_gen = torch.Generator(device=dev).manual_seed(0)
    step(state, batch, step_gen)
    for data, idx, m in capture("segment_sum",
                                lambda: step(state, batch, step_gen)):
        rows.append(row("geo", "segment_sum", data, idx, m, dev, args.iters))
    del state, batch
    result = {"tag": args.tag, "device": str(dev),
              "uniform": [{k: r[k] for k in ("kernel", "shape", "ms",
                                             "device_ms")} for r in rows
                          if r["part"] == "uniform"],
              "geo": total(rows, "geo")}

    if not args.skip_request:
        cfg = kitti_config(compute_dtype="float32", **FLAGSHIP_CFG) \
            if args.config == "kitti" else CONFIGS[args.config](
                compute_dtype="float32", **FLAGSHIP_CFG)
        # a small grid nominates at most 2 * nlabel candidates
        opts = dict(FLAGSHIP_OPTS,
                    hypotheses=min(FLAGSHIP_OPTS["hypotheses"], 2 * cfg.nlabel))
        batch, _, pipeline = serve.build_composed_workload(
            cfg, b, dev, seed=0, **opts)
        with torch.no_grad():
            pipeline(batch)
            device_sync(dev)
            calls = capture("segment_sum_shared", lambda: pipeline(batch))
            by_name = device_ms_by_name(lambda: pipeline(batch), dev, 1)
            for data, idx, m in calls:
                rows.append(row("request", "segment_sum_shared", data, idx,
                                m, dev, 3))
        del calls
        result["request"] = total(rows, "request")
        result["request"]["kernel_in_request_device_ms"] = (
            None if by_name is None else
            sum(t for k, t in by_name.items() if "segment_sum_shared" in k))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
