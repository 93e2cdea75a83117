"""The two segment sums (kernels 5 and 7), the exact knn (kernel 3), the
projection-fused raster (kernel 4), the segment softmax-attend (kernel 1),
the pixel-id raster (kernel 6a), the compacting raster (kernel 8), the
mask-pack compaction (kernel 11) and the factored raster (kernel 6b) timed
alone, at the shapes their checks use and on the calls their paths make,
one tree of the port per process, so that two trees can be compared in
turns on one card.

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
           request (``--skip-request`` leaves this part out);
  knn      kernel 3 at the serving shape (the nodes against themselves,
           k = ``knn_k``) and on its call in one geo forward (random
           weights, the synthetic batch from seed 0, captured);
  raster   kernel 4 at the serving shape (the top-K rows of a random
           cloud, some behind the camera) in f32, bf16 and int8, and on the
           10 calls of one bf16 + int8 episode (the overlap head centred so
           that about half the rows are valid, captured);
  paths    the device time of whole paths, every kernel summed: one bf16 +
           int8 serving episode (the overlap head centred) and one bf16 +
           int8 composed request at the flagship options;
  softmax  kernel 1 at the serving shape (points -> nodes, uniform ids) on
           f32 and on bf16 operands, and on the 4 calls of one geo forward
           in f32 and in bf16, with each geo forward's whole device time (a
           tree whose kernel reads f32 only gets bf16 operands widened by
           the caller, as its point encoder widened them, the cast counted
           in the call: ``widened_by_caller``);
  image    kernel 6a at the training shape (valid-first rows, a third of
           the valid prefix outside the frame) in f32, bf16 and int8, on
           the calls of one agent-training run's rollouts and on the 10
           calls of one "flat" bf16 + int8 episode (the overlap head
           centred);
  compact  kernel 8 in f32, bf16 and int8 on the busiest call of one f32
           "compact" episode (the overlap head centred; f32 rows), the same
           call with every row routed out (what scanning the ids costs),
           then on the 10 calls of that episode and of one bf16 + int8
           "compact" episode, with each episode's whole device time;
  pack     kernel 11 at the "pack" episode's shape (``mask [B, num_pt]``,
           70% kept, f32 features, k = num_pt / 2);
  factored kernel 6b (``segment_sum_image``) on the raster probe's rows
           (every row in the frame) and on a training raster's ids, in f32
           and bf16, with the count column appended (F + 1) and without it
           (F), then the raster probe's "fact" and "flat" means at
           valid-frac 1.0 (every kernel the call runs, the parent's ones
           column and division included, in ``device_all_ms``).

A row holds the wrapper's ms (CUDA events around repeated calls), the
device ms of every kernel whose name contains "segment" (``torch.profiler``,
by name), whether two launches gave the same bits, how the ids spread
(rows landing, most rows on one segment) and, for kernel 5, the ms of one
``scatter_add_`` into a zeroed output with the index prepared. A knn,
raster, softmax, image, compact, pack or factored row holds the wrapper's
ms, the device ms by name of the kernels whose names contain "knn",
"raster", "softmax" or "mask", the device ms of every kernel the call ran
(``device_all_ms``: PyTorch's passes around a kernel, its fills and casts,
included; the name filter misses kernels of older trees named otherwise,
such as an older kernel 1's ``channel_max_kernel``) and whether two
launches gave the same bits. The tool imports the tree it runs from and
names no kernel, so to time another tree (a parent's), copy this file into
that tree's ``cmr_agent_tpu_torch/tools/`` and run it from that tree's
root::

    python -m cmr_agent_tpu_torch.tools.segment_turns [--tag NAME]
        [--parts uniform,geo,request,knn,raster,paths,softmax,image,
                 compact,pack,factored]

Prints one JSON line per row and, last, one with the totals per part;
diagnostics on stderr. With ``--device cpu --config micro`` a rehearsal at
a small size: the wrappers run their plain versions, times come from the
host clock and device times are null.
"""

from __future__ import annotations

import argparse
import dataclasses
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


def capture_calls(name: str, fn):
    """Runs ``fn()`` with ``kernels.<name>`` recording copies of its
    arguments; returns ``(args, kwargs)`` per call, in call order."""
    calls = []
    wrapper = getattr(kernels, name)

    def copy(a):
        return a.detach().clone() if isinstance(a, torch.Tensor) else a

    def record(*args, **kw):
        calls.append((tuple(copy(a) for a in args),
                      {k: copy(v) for k, v in kw.items()}))
        return wrapper(*args, **kw)
    # the wrapper counts its launches on the module's attribute
    record.launches = wrapper.launches
    setattr(kernels, name, record)
    try:
        fn()
    finally:
        wrapper.launches = record.launches
        setattr(kernels, name, wrapper)
    return calls


def capture(name: str, fn):
    """:func:`capture_calls` of a segment sum: ``(data, idx,
    num_segments)`` per call."""
    return [(args[0], args[1], int(args[2]))
            for args, _ in capture_calls(name, fn)]


def wall_ms(fn, iters: int, dev: torch.device) -> float:
    """ms per call: CUDA events on the card, the host clock on the CPU."""
    if dev.type == "cuda":
        return cuda_ms(fn, iters)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def device_ms_by_name(fn, dev: torch.device, iters: int,
                      key: str = "segment"):
    """Device ms per call of each kernel whose name holds ``key`` (every
    kernel for ``key=""``); None on the CPU. A profile that recorded no
    device row at all (``torch.profiler`` now and then returns none for a
    short window) is taken again, up to three times."""
    if dev.type != "cuda":
        return None
    fn()
    for _ in range(3):
        by_name, _ = profile_device(fn, iters=iters)
        if by_name:
            break
    out = {}
    for k, (t, _) in by_name.items():
        if key in k:  # names cut to 60 characters: add those that meet
            out[k[:60]] = out.get(k[:60], 0.0) + t / iters
    return out


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


def same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    return all(same_bits(x, y) for x, y in zip(a, b))


def call_row(part: str, name: str, key: str, args, kw, dev,
             iters: int, prep=None) -> dict:
    """One kernel call: wrapper ms, device ms of the kernels whose names
    hold ``key`` and of every kernel the call ran, same bits twice.
    ``prep`` maps the arguments at every call (its work is timed too)."""
    fn = getattr(kernels, name)

    def call():
        return fn(*(args if prep is None else prep(args)), **kw)
    first = call()
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    out = dict(part=part, kernel=name, shape=[list(a.shape) for a in tensors],
               dtypes=[str(a.dtype) for a in tensors],
               options={k: str(v) for k, v in kw.items()},
               same_bits=same_bits(call(), first))
    if prep is not None:
        out["widened_by_caller"] = True
    if name == "segment_mean_count_image_project":
        out["valid_rows"] = int(args[3].sum())
    if name in ("segment_mean_count_image_project",
                "segment_mean_count_image",
                "segment_sum_count_image_compact"):
        out["landed_rows"] = int(first[1].sum())
    del first
    out["ms"] = wall_ms(call, iters, dev)
    every = device_ms_by_name(call, dev, max(3, iters // 4), key="")
    out["device_ms"] = (None if every is None else
                        {k: t for k, t in every.items() if key in k})
    out["device_all_ms"] = None if every is None else sum(every.values())
    print(json.dumps(out), flush=True)
    return out


def raster_cloud(b: int, k: int, f: int, h: int, w: int, dev,
                 gen: torch.Generator):
    """``(pcT, feat, ab, counts)`` of kernel 4 at a serving shape, drawn
    from ``gen`` on the CPU: valid-first clouds through a yawed pinhole
    camera, 20 pixels wider and 10 taller than the frame, a fortieth of the
    rows behind the camera, a quarter to all of them valid, f32 features
    (the dtype the bf16 episode hands the raster)."""
    fx = 1.2 * w
    z = torch.rand(b, k, generator=gen) * 38 + 2
    u = torch.rand(b, k, generator=gen) * (w + 20) - 10
    v = torch.rand(b, k, generator=gen) * (h + 10) - 5
    pc = torch.stack([(u - w / 2) * z / fx, (v - h / 2) * z / fx, z], 1)
    pc[:, 2, :k // 40] *= -1.0
    feat = torch.randn(b, k, f, generator=gen)
    counts = torch.randint(k // 4, k + 1, (b,), generator=gen,
                           dtype=torch.int32)
    cam = torch.tensor([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])
    yaw = torch.rand(b, generator=gen) * 0.2 - 0.1
    R = torch.zeros(b, 3, 3)
    R[:, 0, 0], R[:, 0, 2] = torch.cos(yaw), torch.sin(yaw)
    R[:, 2, 0], R[:, 2, 2] = -torch.sin(yaw), torch.cos(yaw)
    R[:, 1, 1] = 1.0
    t = torch.randn(b, 3, generator=gen) * 0.3
    ab = torch.cat([(cam @ R).reshape(b, 9), t @ cam.T], 1)
    return (pc.contiguous().to(dev), feat.to(dev), ab.contiguous().to(dev),
            counts.to(dev))


def knn_part(cfg, b: int, dev, gen, iters: int, rows: list) -> None:
    """Kernel 3 at the serving shape, then on a geo forward's calls."""
    xyz = (torch.randn(b, cfg.num_node, 3, generator=gen) * 20).to(dev)
    rows.append(call_row("knn_uniform", "knn", "knn", (xyz, xyz, cfg.knn_k),
                         {}, dev, iters))
    batch, model, _, _ = serve.build_workload(cfg, b, dev, seed=0)
    with torch.inference_mode():
        calls = capture_calls("knn", lambda: model(batch))
    for args, kw in calls:
        rows.append(call_row("knn_path", "knn", "knn", args, kw, dev, iters))
    del model, batch


def raster_part(cfg, b: int, dev, gen, iters: int, rows: list) -> None:
    """Kernel 4 at the serving shape in f32, bf16 and int8, then on the
    calls of one bf16 + int8 episode."""
    k, f = cfg.episode_raster_topk() or cfg.num_pt // 2, cfg.embed_dim
    pcT, feat, ab, counts = raster_cloud(b, k, f, cfg.image_h, cfg.image_w,
                                         dev, gen)
    for mode, dt in (("f32", None), ("bf16", torch.bfloat16),
                     ("int8", torch.int8)):
        rows.append(call_row(f"raster_{mode}", "segment_mean_count_image_"
                             "project", "raster", (pcT, feat, ab, counts,
                                                   cfg.image_h, cfg.image_w),
                             {"compute_dtype": dt}, dev, iters))
    ep_cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    batch, model, agent, _ = serve.build_workload(ep_cfg, b, dev, seed=0)
    serve.centre_overlap_head_(model, batch)
    calls = capture_calls("segment_mean_count_image_project",
                          lambda: serve.serve_episode(model, agent, ep_cfg,
                                                      batch))
    for args, kw in calls:
        rows.append(call_row("raster_episode",
                             "segment_mean_count_image_project", "raster",
                             args, kw, dev, iters))
    del model, agent, batch


def softmax_prep(args):
    """None where this tree's kernel 1 takes the call's operands as they
    are; else (a tree whose kernel reads f32 only, given bf16) the
    caller's widening of attn and values to f32."""
    try:
        kernels.segment_softmax_attend(*args)
        return None
    except TypeError:
        return lambda a: (a[0].float(), a[1].float(), *a[2:])


def softmax_part(cfg, b: int, dev, gen, iters: int, rows: list,
                 result: dict) -> None:
    """Kernel 1 at the serving shape on f32 and bf16 operands, then on the
    calls of one f32 and one bf16 geo forward, with each forward's whole
    device time (every kernel summed; None on the CPU)."""
    n, m, f = cfg.num_pt, cfg.num_node, cfg.embed_dim
    attn = (torch.randn(b, n, f, generator=gen) * 2).to(dev)
    values = torch.randn(b, n, f, generator=gen).to(dev)
    idx = torch.randint(0, m, (b, n), generator=gen,
                        dtype=torch.int32).to(dev)
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = (attn.to(dt), values.to(dt), idx, m)
        rows.append(call_row(f"softmax_{tag}", "segment_softmax_attend",
                             "softmax", args, {}, dev, iters,
                             softmax_prep(args)))
    del attn, values, idx
    for dtype in ("float32", "bfloat16"):
        g_cfg = dataclasses.replace(cfg, compute_dtype=dtype)
        batch, model, _, _ = serve.build_workload(g_cfg, b, dev, seed=0)
        with torch.inference_mode():
            calls = capture_calls("segment_softmax_attend",
                                  lambda: model(batch))
            for args, kw in calls:
                rows.append(call_row(f"softmax_geo_{dtype}",
                                     "segment_softmax_attend", "softmax",
                                     args, kw, dev, iters,
                                     softmax_prep(args)))
            every = device_ms_by_name(lambda: model(batch), dev, 2, key="")
        result[f"geo_forward_{dtype}_device_ms"] = (
            None if every is None else sum(every.values()))
        del batch, model, calls


def train_raster_ids(b: int, k: int, hw: int, gen: torch.Generator):
    """Pixel ids ``[b, k]`` int32 (CPU) of a training raster: valid-first,
    a quarter to all of the rows valid, a third of the valid prefix
    outside the frame (``hw``)."""
    counts = torch.randint(k // 4, k + 1, (b, 1), generator=gen)
    row = torch.arange(k)[None, :]
    lands = (row < counts) & (torch.rand(b, k, generator=gen) > 1 / 3)
    return torch.where(lands, torch.randint(0, hw, (b, k), generator=gen),
                       torch.full((b, k), hw)).to(torch.int32)


def agent_raster_calls(cfg, b: int, dev):
    """Kernel 6a's calls in one agent-training run's ``num_trajectory``
    rollouts (random weights, the synthetic batch from seed 0), captured:
    ``(args, kwargs)`` per call."""
    from ..train import train_agent, train_geo
    batch = serve.synthetic_batch(cfg, b, dev, seed=0, keys=serve.TRAIN_KEYS)
    geo = train_geo.create_geo_state(cfg, dev, seed=0).model
    geo_out = train_geo.make_geo_forward(cfg)(geo, batch)
    state = train_agent.create_agent_state(cfg, dev, seed=1)
    rollout = train_agent.make_rollout_fn(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    return capture_calls("segment_mean_count_image", lambda: [
        rollout(state, geo_out, batch, gen)
        for _ in range(cfg.num_trajectory)])


def flat_episode_raster_calls(cfg, b: int, dev):
    """Kernel 6a's calls in one "flat" bf16 + int8 serving episode (seed
    0, the overlap head centred), captured."""
    ep_cfg = dataclasses.replace(cfg, raster_mode="flat",
                                 compute_dtype="bfloat16")
    batch, model, agent, _ = serve.build_workload(ep_cfg, b, dev, seed=0)
    serve.centre_overlap_head_(model, batch)
    return capture_calls("segment_mean_count_image",
                         lambda: serve.serve_episode(model, agent, ep_cfg,
                                                     batch))


def image_part(cfg, b: int, dev, gen, iters: int, rows: list) -> None:
    """Kernel 6a at the training shape in f32, bf16 and int8, then on the
    calls of one agent-training run and of one "flat" bf16 + int8
    episode."""
    h, w, f = cfg.image_h, cfg.image_w, cfg.embed_dim
    k = cfg.episode_raster_topk() or cfg.num_pt // 2
    ids = train_raster_ids(b, k, h * w, gen).to(dev)
    data = torch.randn(b, k, f, generator=gen).to(dev)
    for mode, dt in (("f32", None), ("bf16", torch.bfloat16),
                     ("int8", torch.int8)):
        rows.append(call_row(f"image_{mode}", "segment_mean_count_image",
                             "raster", (data, ids, h, w, dt), {}, dev,
                             iters))
    del data, ids
    for part, calls in (("image_train", agent_raster_calls(cfg, b, dev)),
                        ("image_flat_episode",
                         flat_episode_raster_calls(cfg, b, dev))):
        for args, kw in calls:
            rows.append(call_row(part, "segment_mean_count_image", "raster",
                                 args, kw, dev, max(2, iters // 4)))


def factored_part(cfg, b: int, dev, gen, iters: int, rows: list) -> None:
    """Kernel 6b (``segment_sum_image``) on the raster probe's rows (every
    row in the frame) and on a training raster's ids, in f32 and bf16, with
    the count column appended (F + 1) and without it (F); then the probe's
    "fact" and "flat" means at valid-frac 1.0 in both dtypes."""
    from .raster_probe import make_inputs
    h, w, f = cfg.image_h, cfg.image_w, cfg.embed_dim
    k = cfg.episode_raster_topk() or cfg.num_pt // 2
    feat, probe_ids = make_inputs(b, k, f, h, w, 1.0, False, dev)
    aug = torch.cat([feat, torch.ones(b, k, 1, device=dev)], -1)
    train_ids = train_raster_ids(b, k, h * w, gen).to(dev)
    for layout, ids in (("probe", probe_ids), ("train", train_ids)):
        for width, data in ((f + 1, aug), (f, feat)):
            for mode, dt in (("f32", None), ("bf16", torch.bfloat16)):
                rows.append(call_row(
                    f"factored_{layout}_{mode}_F{width}", "segment_sum_image",
                    "raster", (data if dt is None else data.to(dt), ids, h,
                               w, dt), {}, dev, iters))
    for mode, dt in (("f32", None), ("bf16", torch.bfloat16)):
        for case, kw in (("fact", {"factored": True}), ("flat", {})):
            rows.append(call_row(f"factored_{case}_{mode}",
                                 "segment_mean_count_image", "raster",
                                 (feat, probe_ids, h, w, dt), kw, dev, iters))


def compact_episode(cfg, b: int, dev, dtype: str):
    """One "compact" serving episode in ``dtype`` (seed 0, the overlap head
    centred) -> ``(kernel 8's calls, captured; the episode's whole device
    ms, every kernel summed, None on the CPU)``."""
    ep_cfg = dataclasses.replace(cfg, raster_mode="compact",
                                 compute_dtype=dtype)
    batch, model, agent, _ = serve.build_workload(ep_cfg, b, dev, seed=0)
    serve.centre_overlap_head_(model, batch)

    def episode():
        return serve.serve_episode(model, agent, ep_cfg, batch)
    calls = capture_calls("segment_sum_count_image_compact", episode)
    every = device_ms_by_name(episode, dev, 2, key="")
    return calls, None if every is None else sum(every.values())


def compact_part(cfg, b: int, dev, iters: int, rows: list,
                 result: dict) -> None:
    """Kernel 8 in three modes on the busiest call of one f32 "compact"
    episode and with that call's rows all routed out, then on the calls of
    that episode and of one bf16 + int8 "compact" episode."""
    by_dtype = {dtype: compact_episode(cfg, b, dev, dtype)
                for dtype in ("float32", "bfloat16")}
    calls = by_dtype["float32"][0]
    hw = cfg.image_h * cfg.image_w
    landed = [int(((a[1] >= 0) & (a[1] < hw)).sum()) for a, _ in calls]
    args, _ = calls[landed.index(max(landed))]
    data, ids = args[0].float().contiguous(), args[1]
    for mode, dt in (("f32", None), ("bf16", torch.bfloat16),
                     ("int8", torch.int8)):
        rows.append(call_row(f"compact_{mode}",
                             "segment_sum_count_image_compact", "raster",
                             (data, ids, *args[2:4], dt), {}, dev, iters))
    rows.append(call_row("compact_routed_out",
                         "segment_sum_count_image_compact", "raster",
                         (data, torch.full_like(ids, hw), *args[2:4], None),
                         {}, dev, iters))
    for dtype, (ep_calls, episode_ms) in by_dtype.items():
        for a, kw in ep_calls:
            rows.append(call_row(f"compact_episode_{dtype}",
                                 "segment_sum_count_image_compact", "raster",
                                 a, kw, dev, max(2, iters // 4)))
        result[f"episode_{dtype}_device_ms"] = episode_ms


def pack_part(cfg, b: int, dev, gen, iters: int, rows: list) -> None:
    """Kernel 11 at the "pack" episode's shape: 70% of ``num_pt`` rows
    kept, f32 features, k = ``num_pt`` / 2."""
    n, f = cfg.num_pt, cfg.embed_dim
    mask = (torch.rand(b, n, generator=gen) < 0.7).to(dev)
    pcT = torch.randn(b, 3, n, generator=gen).to(dev)
    feat = torch.randn(b, n, f, generator=gen).to(dev)
    rows.append(call_row("pack", "mask_compact_pack", "mask",
                         (mask, pcT, feat, n // 2), {}, dev, iters))


def paths_part(cfg, b: int, dev, result: dict) -> None:
    """Device ms of one bf16 + int8 episode and one bf16 + int8 composed
    request, every kernel summed (None on the CPU)."""
    def device_total(fn, iters):
        every = device_ms_by_name(fn, dev, iters, key="")
        return None if every is None else sum(every.values())
    ep_cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    batch, model, agent, _ = serve.build_workload(ep_cfg, b, dev, seed=0)
    serve.centre_overlap_head_(model, batch)
    episode_ms = device_total(
        lambda: serve.serve_episode(model, agent, ep_cfg, batch), 2)
    del batch, model, agent
    rcfg = dataclasses.replace(cfg, compute_dtype="bfloat16", **FLAGSHIP_CFG)
    opts = dict(FLAGSHIP_OPTS, hypotheses=min(FLAGSHIP_OPTS["hypotheses"],
                                              2 * rcfg.nlabel))
    batch, _, pipeline = serve.build_composed_workload(rcfg, b, dev, seed=0,
                                                       **opts)
    with torch.no_grad():
        request_ms = device_total(lambda: pipeline(batch), 1)
    result["paths"] = {"episode_bf16_int8_device_ms": episode_ms,
                       "request_bf16_int8_device_ms": request_ms}


def total(rows, part: str) -> dict:
    picked = [r for r in rows if r["part"] == part]
    out = dict(calls=len(picked), ms=sum(r["ms"] for r in picked),
               same_bits=all(r["same_bits"] for r in picked))
    if picked and picked[0]["device_ms"] is not None:
        out["device_ms"] = sum(sum(r["device_ms"].values()) for r in picked)
    if picked and picked[0].get("device_all_ms") is not None:
        out["device_all_ms"] = sum(r["device_all_ms"] for r in picked)
    if picked and "scatter_add_ms" in picked[0]:
        out["scatter_add_ms"] = sum(r["scatter_add_ms"] for r in picked)
    return out


PARTS = ("uniform", "geo", "request", "knn", "raster", "paths", "softmax",
         "image", "compact", "pack", "factored")


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
    ap.add_argument("--parts", default=",".join(PARTS),
                    help="comma-separated parts to run, of " + ",".join(PARTS))
    ap.add_argument("--skip-request", action="store_true",
                    help="leave the request part out")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    parts = [p for p in args.parts.split(",") if p]
    if args.skip_request:
        parts = [p for p in parts if p != "request"]
    if not set(parts) <= set(PARTS):
        raise ValueError(f"unknown parts {sorted(set(parts) - set(PARTS))}")
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
    result = {"tag": args.tag, "device": str(dev)}

    def draw(n, m, width, *maps):
        data = torch.randn(b, n, width, generator=gen).to(dev)
        idx = torch.randint(0, m, (b, *maps, n), generator=gen,
                            dtype=torch.int32).to(dev)
        return data, idx

    if "uniform" in parts:
        for n, m in ((cfg.num_pt, cfg.num_node),
                     (cfg.num_node * cfg.knn_k, cfg.num_node),
                     (cfg.num_node, cfg.num_proxy)):
            data, idx = draw(n, m, f)
            rows.append(row("uniform", "segment_sum", data, idx, m, dev,
                            args.iters))
        npix, warp_k = cfg.image_h * cfg.image_w, min(8192, cfg.num_pt)
        data, idx = draw(warp_k, int(npix * 2.5), f + 2, args.hypotheses)
        idx[:, 1] = npix
        rows.append(row("uniform", "segment_sum_shared", data, idx, npix,
                        dev, max(2, args.iters // 4)))
        del data, idx
        result["uniform"] = [{k: r[k] for k in ("kernel", "shape", "ms",
                                                "device_ms")} for r in rows
                             if r["part"] == "uniform"]

    if "geo" in parts:
        from ..train.train_geo import create_geo_state, make_geo_train_step
        batch = serve.synthetic_batch(cfg, b, dev, seed=0,
                                      keys=serve.TRAIN_KEYS)
        state = create_geo_state(cfg, dev, seed=0)
        step = make_geo_train_step(cfg)
        step_gen = torch.Generator(device=dev).manual_seed(0)
        step(state, batch, step_gen)
        for data, idx, m in capture("segment_sum",
                                    lambda: step(state, batch, step_gen)):
            rows.append(row("geo", "segment_sum", data, idx, m, dev,
                            args.iters))
        del state, batch
        result["geo"] = total(rows, "geo")

    if "request" in parts:
        rcfg = kitti_config(compute_dtype="float32", **FLAGSHIP_CFG) \
            if args.config == "kitti" else CONFIGS[args.config](
                compute_dtype="float32", **FLAGSHIP_CFG)
        # a small grid nominates at most 2 * nlabel candidates
        opts = dict(FLAGSHIP_OPTS, hypotheses=min(FLAGSHIP_OPTS["hypotheses"],
                                                  2 * rcfg.nlabel))
        batch, _, pipeline = serve.build_composed_workload(
            rcfg, b, dev, seed=0, **opts)
        with torch.no_grad():
            pipeline(batch)
            device_sync(dev)
            calls = capture("segment_sum_shared", lambda: pipeline(batch))
            by_name = device_ms_by_name(lambda: pipeline(batch), dev, 1)
            for data, idx, m in calls:
                rows.append(row("request", "segment_sum_shared", data, idx,
                                m, dev, 3))
        del calls, pipeline, batch
        result["request"] = total(rows, "request")
        result["request"]["kernel_in_request_device_ms"] = (
            None if by_name is None else
            sum(t for k, t in by_name.items() if "segment_sum_shared" in k))

    if "knn" in parts:
        knn_part(cfg, b, dev, gen, args.iters, rows)
        result["knn"] = {p: total(rows, p) for p in ("knn_uniform",
                                                     "knn_path")}
    if "raster" in parts:
        raster_part(cfg, b, dev, gen, args.iters, rows)
        result["raster"] = {p: total(rows, p) for p in (
            "raster_f32", "raster_bf16", "raster_int8", "raster_episode")}
    if "paths" in parts:
        paths_part(cfg, b, dev, result)
    if "softmax" in parts:
        result["softmax"] = {}
        softmax_part(cfg, b, dev, gen, args.iters, rows, result["softmax"])
        result["softmax"].update({p: total(rows, p) for p in (
            "softmax_f32", "softmax_bf16", "softmax_geo_float32",
            "softmax_geo_bfloat16")})
    if "image" in parts:
        image_part(cfg, b, dev, gen, args.iters, rows)
        result["image"] = {p: total(rows, p) for p in (
            "image_f32", "image_bf16", "image_int8", "image_train",
            "image_flat_episode")}
    if "compact" in parts:
        result["compact"] = {}
        compact_part(cfg, b, dev, args.iters, rows, result["compact"])
        result["compact"].update({p: total(rows, p) for p in (
            "compact_f32", "compact_bf16", "compact_int8",
            "compact_routed_out", "compact_episode_float32",
            "compact_episode_bfloat16")})
    if "pack" in parts:
        pack_part(cfg, b, dev, gen, args.iters, rows)
        result["pack"] = total(rows, "pack")
    if "factored" in parts:
        factored_part(cfg, b, dev, gen, args.iters, rows)
        result["factored"] = {p: total(rows, p) for p in dict.fromkeys(
            r["part"] for r in rows if r["part"].startswith("factored_"))}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
