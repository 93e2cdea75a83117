#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cmr_agent_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (a failure in any phase raises and exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``cmr_agent_tpu_torch/csrc`` (into
   ``build/cuda/``) and report the build time;
3. each kernel at the serving path's KITTI shapes against its plain
   PyTorch version on the card, with its time, the plain version's time,
   the least time the card could take (from the bytes or operations the
   function needs) and, where one PyTorch call computes the same function,
   that call's time;
4. the serving path itself through ``serve.build_workload``: KITTI width,
   batch 8, random weights from a seed, geo forward + 10-step episode, in
   f32 and in bf16 with the int8 raster, each then again with the kernels
   swapped for their plain versions to compare per-step logits, actions
   and final poses (and, in f32, the geo outputs). It shows each kernel's launch count over one
   episode, the median pairs/s over timed episodes, and a profile of one
   episode (device busy share, the port kernels' device time, the top
   kernels by device time);
5. the training path's kernels (segment sum, softmax-attend backward,
   pixel-id image raster in f32 and bf16) at the training shapes against
   their plain versions, the backward kernels also against
   ``torch.autograd`` of the plain forward, with the same timings;
6. the geo train step (``train.train_geo``) at KITTI width, B=8, f32:
   launch counts of one step, its peak device memory, the median steps/s
   with dropout on, a profile of one step, then its gradients and three
   steps' losses against a twin with the plain kernels (dropout off);
7. the agent's BC + PPO training (``train.train_agent``) on the frozen
   geo outputs, as ``cli/train_agent.py`` drives it: ``num_trajectory``
   stochastic rollouts into the buffer, then shuffled full minibatches of
   ``ppo_batch_size`` through the update, with launch counts, rollout and
   update times and a profile of one rollout; then an ``expert_beta=1.0``
   rollout and one update against their plain-kernel twins;
8. the coarse-to-fine path's two kernels (the shared-data segment sum of
   the cost volume's warp, with a dead hypothesis, and the mask-pack
   compaction with counts above and below its budget, f32 and bf16) at
   their KITTI shapes against their plain versions, with the same
   timings;
9. ``IterModel`` at KITTI width, B=8, f32 (729 hypotheses in 3 chunks):
   launches, ms per forward, peak memory, a profile, and its logits and
   decoded pose against the plain-kernel twin;
10. the composed pipeline (``serve.build_composed_workload``) at the
    flagship setting (13 hypotheses, 2 cost-volume iterations, one verified
    refine round over a 3-member beam, pose-aware + bearing observation,
    bearing init, unmasked cost volume), in f32 and in bf16 with the int8
    raster: launch counts of one request, requests/s and pairs/s; its
    first stages (geo forward, first cost-volume forward, the first
    candidate's re-perception and its episode step by step), each against
    the plain kernels on the same input;
    the time of its stages alone on the same modules; a profile; and the
    whole request's candidate scores and poses against the plain-kernel
    twin beside a second run of the kernels themselves (f32 atomics make
    every run differ a little; held in f32, reported in bf16);
11. one serving episode under ``raster_mode`` "pack" and one under "mega"
    against their plain twins (one mask-pack launch each).

The last lines are the kernels' JSON summary, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Needs a CUDA card: without one it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 (non-tensor-core)
# rate; the bound of a kernel is the larger of bytes/BW and ops/rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
B, N_PT, N_NODE, N_PROXY, F, KNN_K = 8, 40960, 1280, 256, 64, 16
RASTER_K, IMG_H, IMG_W = 20480, 40, 128


def line(tag: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{tag}] {body}", flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` per call over ``iters`` calls (CUDA
    events, after 3 warm-up calls)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rand_factory(torch, seed: int, dev):
    """``(gen, randn, randint)`` drawing on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).to(dev)
    return gen, randn, randint


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch, kernels, dev):
    """Phase 3: every kernel vs its plain version at the serving shapes."""
    gen, randn, randint = rand_factory(torch, 1234, dev)
    rows = {}

    # 1. segment softmax-attend: 3x points -> nodes, 1x nodes -> proxies
    for n, m in ((N_NODE, N_PROXY), (N_PT, N_NODE)):
        attn, values = randn(B, n, F, scale=2.0), randn(B, n, F)
        idx = randint(0, m, B, n)
        got = kernels.segment_softmax_attend(attn, values, idx, m)
        want = kernels.segment_softmax_attend_plain(attn, values, idx, m)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        err = (got - want).abs().max().item()
    ms = cuda_ms(lambda: kernels.segment_softmax_attend(attn, values, idx, m),
                 20)
    plain_ms = cuda_ms(lambda: kernels.segment_softmax_attend_plain(
        attn, values, idx, m), 5)
    nbytes = 2 * B * N_PT * F * 4 + B * N_PT * 4 + B * N_NODE * F * 4
    rows["segment_softmax_attend"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        tol="rtol 1e-5 atol 1e-6 (f32 atomics reorder sums)",
        shape=f"[{B},{N_PT},{F}]->[{B},{N_NODE},{F}]",
        bound=bound(nbytes, 6.0 * B * N_PT * F))

    # 2. gather rows: node tables read by every point (f32, bf16, xyz) and
    #    by every knn slot
    table = randn(B, N_NODE, F)
    idx = randint(0, N_NODE, B, N_PT)
    for tab, ix in ((table, idx), (table.to(torch.bfloat16), idx),
                    (randn(B, N_NODE, 3), idx),
                    (table, randint(0, N_NODE, B, N_NODE * KNN_K))):
        got = kernels.gather_rows(tab, ix)
        assert torch.equal(got, kernels.gather_rows_plain(tab, ix)), tab.shape
    oob = idx.clone()
    oob[:, :7] = N_NODE + 5
    assert torch.equal(kernels.gather_rows(table, oob),
                       kernels.gather_rows_plain(table, oob))
    idx64 = idx.long()[..., None].expand(B, N_PT, F)
    ms = cuda_ms(lambda: kernels.gather_rows(table, idx), 50)
    plain_ms = cuda_ms(lambda: kernels.gather_rows_plain(table, idx), 20)
    library_ms = cuda_ms(lambda: torch.gather(table, 1, idx64), 50)
    nbytes = B * N_NODE * F * 4 + B * N_PT * 4 + B * N_PT * F * 4
    rows["gather_rows"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        tol="exact", shape=f"[{B},{N_NODE},{F}]x[{B},{N_PT}] f32",
        bound=bound(nbytes, 0.0))

    # 3. knn over the nodes
    xyz = randn(B, N_NODE, 3, scale=20.0)
    got = kernels.knn(xyz, xyz, KNN_K)
    want = kernels.knn_plain(xyz, xyz, KNN_K)
    assert torch.equal(got.sort(-1).values, want.sort(-1).values)
    sqn = (xyz * xyz).sum(-1)

    def dist(ix):
        nb = torch.gather(xyz[:, None].expand(-1, N_NODE, -1, -1), 2,
                          ix.long()[..., None].expand(-1, -1, -1, 3))
        return torch.gather(sqn[:, None].expand(-1, N_NODE, -1), 2,
                            ix.long()) - 2 * (nb * xyz[:, :, None]).sum(-1)
    err = (dist(got).sort(-1).values - dist(want).sort(-1).values
           ).abs().max().item()
    assert err <= 1e-3, err
    ms = cuda_ms(lambda: kernels.knn(xyz, xyz, KNN_K), 20)
    plain_ms = cuda_ms(lambda: kernels.knn_plain(xyz, xyz, KNN_K), 5)
    nbytes = 2 * B * N_NODE * 3 * 4 + B * N_NODE * KNN_K * 4
    rows["knn"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        tol="same neighbour sets; sorted distances within 1e-3",
        shape=f"[{B},{N_NODE},3] k={KNN_K}",
        bound=bound(nbytes, 7.0 * B * N_NODE * N_NODE))

    # 4. projection-fused raster: valid-first clouds, some behind the camera
    fx = 1.2 * IMG_W
    z = torch.rand(B, RASTER_K, generator=gen) * 38 + 2
    u = torch.rand(B, RASTER_K, generator=gen) * (IMG_W + 20) - 10
    v = torch.rand(B, RASTER_K, generator=gen) * (IMG_H + 10) - 5
    pc = torch.stack([(u - IMG_W / 2) * z / fx, (v - IMG_H / 2) * z / fx, z],
                     1)
    pc[:, 2, :RASTER_K // 40] *= -1.0
    pcT = pc.contiguous().to(dev)
    feat = randn(B, RASTER_K, F)
    counts = torch.randint(RASTER_K // 4, RASTER_K + 1, (B,), generator=gen,
                           dtype=torch.int32).to(dev)
    Kc = torch.tensor([[fx, 0, IMG_W / 2], [0, fx, IMG_H / 2], [0, 0, 1]])
    yaw = torch.rand(B, generator=gen) * 0.2 - 0.1
    R = torch.zeros(B, 3, 3)
    R[:, 0, 0], R[:, 0, 2] = torch.cos(yaw), torch.sin(yaw)
    R[:, 2, 0], R[:, 2, 2] = -torch.sin(yaw), torch.cos(yaw)
    R[:, 1, 1] = 1.0
    t = torch.randn(B, 3, generator=gen) * 0.3
    ab = torch.cat([(Kc @ R).reshape(B, 9), t @ Kc.T], 1).contiguous().to(dev)
    modes = {}
    for mode, dt in (("f32", None), ("bf16", torch.bfloat16),
                     ("int8", torch.int8)):
        gm, gc = kernels.segment_mean_count_image_project(
            pcT, feat, ab, counts, IMG_H, IMG_W, dt)
        wm, wc = kernels.segment_mean_count_image_project_plain(
            pcT, feat, ab, counts, IMG_H, IMG_W, dt)
        assert torch.equal(gc, wc), mode
        assert wc.sum() > 0.3 * counts.sum().item(), mode
        if mode == "f32":
            landed = int(wc.sum().item())
        torch.testing.assert_close(gm, wm, rtol=1e-5, atol=1e-6)
        modes[mode] = dict(
            err=(gm - wm).abs().max().item(),
            ms=cuda_ms(lambda: kernels.segment_mean_count_image_project(
                pcT, feat, ab, counts, IMG_H, IMG_W, dt), 20),
            plain_ms=cuda_ms(lambda: kernels.segment_mean_count_image_project_plain(
                pcT, feat, ab, counts, IMG_H, IMG_W, dt), 5))
        line("raster_mode", mode=mode, max_abs_err=modes[mode]["err"],
             kernel_ms=f"{modes[mode]['ms']:.5f}",
             plain_ms=f"{modes[mode]['plain_ms']:.5f}")
    # every valid row's xyz is read and projected; only the rows that land
    # in the frame need their F features read and added
    valid = int(counts.sum().item())
    out_bytes = B * IMG_H * IMG_W * (F + 1) * 4
    nbytes = valid * 3 * 4 + landed * F * 4 + B * (12 + 1) * 4 + out_bytes
    rows["segment_mean_count_image_project"] = dict(
        max_abs_err=modes["f32"]["err"], ms=modes["f32"]["ms"],
        plain_ms=modes["f32"]["plain_ms"], library_ms=None,
        tol="counts exact; means rtol 1e-5 atol 1e-6 (f32, bf16, int8)",
        shape=f"[{B},3,{RASTER_K}] F={F} {IMG_H}x{IMG_W} f32, "
              f"{valid} valid rows, {landed} in the frame",
        bound=bound(nbytes, 20.0 * valid + (F + 1.0) * landed))

    print_rows(rows)
    return rows


def print_rows(rows) -> None:
    for name, r in rows.items():
        line("kernel", name=name, shape=repr(r["shape"]), tol=repr(r["tol"]),
             max_abs_err=r["max_abs_err"], kernel_ms=f"{r['ms']:.5f}",
             plain_ms=f"{r['plain_ms']:.5f}",
             bound_us=f"{r['bound'][0] * 1e3:.2f}({r['bound'][1]})",
             library_ms=("none" if r["library_ms"] is None
                         else f"{r['library_ms']:.5f}"))


def plain_kernels(kernels):
    """Context manager: route the path's kernel calls to the plain versions
    (the path calls ``kernels.<name>`` at run time)."""
    import contextlib

    @contextlib.contextmanager
    def swap():
        saved = {name: getattr(kernels, name) for name in kernels.PLAIN}
        try:
            for name, fn in kernels.PLAIN.items():
                setattr(kernels, name, fn)
            yield
        finally:
            for name, fn in saved.items():
                setattr(kernels, name, fn)
    return swap()


def compare_episodes(torch, got, want, atol: float, rtol: float = 0.0):
    """Per-step logits (within ``atol + rtol * max|logit|`` of the step) and
    actions (where the top-2 margin exceeds that tolerance) while the action
    history agrees, then the final poses. Returns (steps compared, max
    logit diff)."""
    max_diff, compared = 0.0, 0
    for (gr, gt), (wr, wt) in zip(got["steps"], want["steps"]):
        for g, w in ((gr, wr), (gt, wt)):
            diff = (g - w).abs().max().item()
            max_diff = max(max_diff, diff)
            logit_tol = atol + rtol * w.abs().max().item()
            assert diff <= logit_tol, f"logits differ by {diff} > {logit_tol}"
            top2 = torch.topk(w, 2, dim=-1).values
            sure = top2[..., 0] - top2[..., 1] > logit_tol
            assert torch.equal(g.argmax(-1)[sure], w.argmax(-1)[sure])
        compared += 1
        if not (torch.equal(gr.argmax(-1), wr.argmax(-1))
                and torch.equal(gt.argmax(-1), wt.argmax(-1))):
            return compared, max_diff  # a near-tie took another action
    torch.testing.assert_close(got["final_pose"], want["final_pose"],
                               rtol=0, atol=1e-4)
    return compared, max_diff


def run_path(torch, kernels, serve, kitti_config, dtype: str):
    """Phase 4 for one compute dtype; returns (launch counts, pairs/s)."""
    cfg = kitti_config(compute_dtype=dtype)
    t0 = time.perf_counter()
    batch, model, agent, episode = serve.build_workload(cfg, B, seed=0)
    torch.cuda.synchronize()
    line("workload", dtype=dtype, raster_int8=cfg.raster_int8,
         raster_topk=cfg.episode_raster_topk(),
         build_s=f"{time.perf_counter() - t0:.2f}")
    episode(batch)                                   # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    final = episode(batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    line("launches", dtype=dtype, **counts)
    # eval episodes run the serving kernels and never the training ones
    assert all(counts[k] > 0 for k in SERVING_KERNELS), counts
    assert all(counts[k] == 0 for k in TRAINING_KERNELS + COMPOSE_KERNELS), \
        counts
    assert final.shape == (B, 4, 4) and torch.isfinite(final).all()

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        episode(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rate = B / statistics.median(times)
    line("throughput", dtype=dtype, pairs_per_s=f"{rate:.3f}",
         episode_s=",".join(f"{t:.4f}" for t in times))

    profile_episode(torch, serve, model, agent, cfg, batch)
    # the same episode with the kernels swapped for their plain versions.
    # f32: the kernels differ from them only by the order of f32 atomic
    # sums. bf16: a sum that differs in its last f32 bit can round to the
    # neighbouring bf16 value, about 2^-8 relative, and that propagates
    # through the bf16 layers to the logits.
    atol, rtol = (1e-3, 0.0) if dtype == "float32" else (1e-2, 3e-2)
    got = serve.serve_episode(model, agent, cfg, batch)
    with torch.inference_mode():
        geo = model(batch)
    with plain_kernels(kernels):
        want = serve.serve_episode(model, agent, cfg, batch)
        with torch.inference_mode():
            geo_plain = model(batch)
    if dtype == "float32":
        for key in ("pc_geo_feat", "img_geo_feat", "pc_overlap_logits"):
            torch.testing.assert_close(geo[key], geo_plain[key], rtol=0,
                                       atol=1e-4)
    steps, diff = compare_episodes(torch, got, want, atol, rtol)
    line("episode_vs_plain", dtype=dtype, logit_atol=atol, logit_rtol=rtol,
         steps_compared=steps, max_logit_diff=diff,
         final_pose_max_diff=(got["final_pose"] - want["final_pose"]
                              ).abs().max().item())
    return counts, rate


SERVING_KERNELS = ("segment_softmax_attend", "gather_rows", "knn",
                   "segment_mean_count_image_project")
TRAINING_KERNELS = ("segment_sum", "segment_softmax_attend_backward",
                    "segment_mean_count_image")
COMPOSE_KERNELS = ("segment_sum_shared", "mask_compact_pack")
PORT_KERNEL_NAMES = ("channel_max_kernel", "softmax_accumulate_kernel",
                     "normalise_kernel", "gather_rows_kernel", "knn_kernel",
                     "raster_project_kernel", "raster_finalise_kernel",
                     "segment_sum_kernel", "softmax_backward_kernel",
                     "raster_image_kernel", "segment_sum_shared_kernel",
                     "mask_count_kernel", "mask_pack_kernel")


def profile_episode(torch, serve, model, agent, cfg, batch) -> None:
    """Device time of one episode by kernel (see :func:`profile_call`)."""
    profile_call(torch, lambda: serve.serve_episode(model, agent, cfg, batch),
                 dtype=cfg.compute_dtype)


def profile_call(torch, fn, unprofiled_ms=None, **tags) -> None:
    """Device time of one call of ``fn`` by kernel (torch.profiler, CUPTI):
    the device's busy share of the wall time and the port kernels' share.
    The profiler slows the host's launches, so where the caller timed the
    same call without it (``unprofiled_ms``) the share of that time is
    printed too. User annotations (``Optimizer.step#Adam.step``) span
    kernels already counted and are left out."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    per_name = {}
    for e in prof.key_averages():     # device-side rows: kernels, copies
        if (getattr(e, "device_type", None) != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        per_name[e.key] = per_name.get(e.key, 0.0) + dev_us / 1e3
    device_ms = sum(per_name.values())
    ours = sum(ms for k, ms in per_name.items()
               if any(n in k for n in PORT_KERNEL_NAMES))
    line("profile", **tags, wall_ms=f"{wall_ms:.3f}",
         device_ms=f"{device_ms:.3f}",
         device_busy_share=(f"{device_ms / wall_ms:.3f}" if device_ms
                            else "not measured"),
         port_kernels_ms=f"{ours:.3f}")
    if unprofiled_ms is not None:
        line("profile_unprofiled", **tags, wall_ms=f"{unprofiled_ms:.3f}",
             device_busy_share=f"{device_ms / unprofiled_ms:.3f}")
    for k, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:12]:
        line("profile_top", ms=f"{ms:.3f}", name=repr(k[:90]))


def check_train_kernels(torch, kernels, dev):
    """Phase 5: the training path's kernels vs their plain versions at the
    training shapes (and the backward kernels vs torch.autograd of the
    plain forward)."""
    gen, randn, randint = rand_factory(torch, 4321, dev)
    rows = {}

    def routed_out(idx, m):
        """A copy of ``idx`` with rows routed out both ways (>= M, -1)."""
        out = idx.clone()
        out[:, :64] = m + 3
        out[:, 64:128] = -1
        return out

    # 5. segment sum (the gather's backward): points -> nodes, the knn
    #    neighbourhoods -> nodes, nodes -> proxies
    for n, m in ((N_PT, N_NODE), (N_NODE * KNN_K, N_NODE), (N_NODE, N_PROXY)):
        data, idx = randn(B, n, F), randint(0, m, B, n)
        for ix in (idx, routed_out(idx, m)):
            got = kernels.segment_sum(data, ix, m)
            want = kernels.segment_sum_plain(data, ix, m)
            # f32 atomics add in another order on every run
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = (got - want).abs().max().item()
        table = randn(B, m, F).requires_grad_()
        table_p = table.detach().clone().requires_grad_()
        g = randn(B, n, F)
        kernels.GatherRowsFn.apply(table, idx).backward(g)
        kernels.gather_rows_plain(table_p, idx).backward(g)
        torch.testing.assert_close(table.grad, table_p.grad, rtol=1e-5,
                                   atol=1e-5)
        idx64 = idx.long()[..., None].expand(B, n, F)
        r = dict(
            max_abs_err=err, tol="rtol 1e-5 atol 1e-5 (f32 atomics reorder "
                                 "sums); gather VJP vs autograd likewise",
            shape=f"[{B},{n},{F}]->[{B},{m},{F}]",
            ms=cuda_ms(lambda: kernels.segment_sum(data, idx, m), 20),
            plain_ms=cuda_ms(lambda: kernels.segment_sum_plain(data, idx, m),
                             10),
            library_ms=cuda_ms(lambda: torch.zeros(B, m, F, device=dev)
                               .scatter_add_(1, idx64, data), 20),
            bound=bound(B * (n * F * 4 + n * 4 + m * F * 4), B * n * F))
        rows.setdefault("segment_sum", r)
        print_rows({f"segment_sum[{n}->{m}]": r})

    # 6. softmax-attend backward, points -> nodes
    n, m = N_PT, N_NODE
    attn, values = randn(B, n, F, scale=2.0), randn(B, n, F)
    idx = routed_out(randint(0, m, B, n), m)
    out, sums, gmax = kernels.segment_softmax_attend(attn, values, idx, m,
                                                     return_stats=True)
    g = randn(B, m, F)
    args = (attn, values, idx, out, sums, gmax, g, m)
    got = kernels.segment_softmax_attend_backward(*args)
    want = kernels.segment_softmax_attend_backward_plain(*args)
    err = 0.0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        err = max(err, (a - b).abs().max().item())
    a_, v_ = (t.detach().clone().requires_grad_() for t in (attn, values))
    kernels.segment_softmax_attend_plain(a_, v_, idx, m).backward(g)
    # autograd differentiates the plain forward's division, another f32
    # formula: its rounding scales with the largest terms
    for a, b in zip(got, (a_.grad, v_.grad)):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * b.abs().max().item())
    valid = int(((idx >= 0) & (idx < m)).sum().item())
    rows["segment_softmax_attend_backward"] = dict(
        max_abs_err=err, tol="rtol 1e-5 atol 1e-6 vs the plain closed form; "
                             "rtol 1e-4 atol 1e-5 max|g| vs autograd",
        shape=f"[{B},{n},{F}] idx->[{B},{m},{F}], {valid} rows in range",
        ms=cuda_ms(lambda: kernels.segment_softmax_attend_backward(*args), 20),
        plain_ms=cuda_ms(
            lambda: kernels.segment_softmax_attend_backward_plain(*args), 10),
        library_ms=None,
        bound=bound(2 * valid * F * 4 + B * n * 4 + 3 * B * m * F * 4
                    + B * F * 4 + 2 * B * n * F * 4, 6.0 * valid * F))
    print_rows({"segment_softmax_attend_backward":
                rows["segment_softmax_attend_backward"]})

    # 7. pixel-id image raster: valid-first rows (a top-K compacted set),
    #    a third of the valid prefix outside the frame
    hw = IMG_H * IMG_W
    counts = torch.randint(RASTER_K // 4, RASTER_K + 1, (B, 1), generator=gen)
    row = torch.arange(RASTER_K)[None, :]
    lands = (row < counts) & (torch.rand(B, RASTER_K, generator=gen) > 1 / 3)
    ids = torch.where(lands, torch.randint(0, hw, (B, RASTER_K),
                                           generator=gen),
                      torch.full((B, RASTER_K), hw)).to(torch.int32).to(dev)
    landed = int(lands.sum().item())
    feat = randn(B, RASTER_K, F)
    gm = randn(B, hw, F)
    modes = {}
    for mode, dt in (("f32", None), ("bf16", torch.bfloat16)):
        data = feat if dt is None else feat.to(dt)
        gmv, gc = kernels.segment_mean_count_image(data, ids, IMG_H, IMG_W, dt)
        wmv, wc = kernels.segment_mean_count_image_plain(data, ids, IMG_H,
                                                         IMG_W, dt)
        assert torch.equal(gc, wc) and int(gc.sum().item()) == landed, mode
        torch.testing.assert_close(gmv, wmv, rtol=1e-5, atol=1e-6)
        d = data.detach().clone().requires_grad_()
        d_p = data.detach().clone().requires_grad_()
        kernels.SegmentMeanCountImageFn.apply(d, ids, IMG_H, IMG_W,
                                              dt)[0].backward(gm)
        kernels.segment_mean_count_image_plain(d_p, ids, IMG_H, IMG_W,
                                               dt)[0].backward(gm)
        torch.testing.assert_close(d.grad, d_p.grad, rtol=1e-5, atol=1e-6)
        elt = data.element_size()
        modes[mode] = dict(
            max_abs_err=(gmv - wmv).abs().max().item(),
            tol="counts exact; means rtol 1e-5 atol 1e-6; VJP vs autograd "
                "likewise",
            shape=f"[{B},{RASTER_K},{F}] {mode} -> {IMG_H}x{IMG_W}, "
                  f"{landed} rows land",
            ms=cuda_ms(lambda: kernels.segment_mean_count_image(
                data, ids, IMG_H, IMG_W, dt), 20),
            plain_ms=cuda_ms(lambda: kernels.segment_mean_count_image_plain(
                data, ids, IMG_H, IMG_W, dt), 10),
            library_ms=None,
            bound=bound(B * RASTER_K * 4 + landed * F * elt
                        + B * hw * (F + 1) * 4,
                        (F + 1.0) * landed + B * hw * F))
        print_rows({f"segment_mean_count_image[{mode}]": modes[mode]})
    rows["segment_mean_count_image"] = modes["f32"]
    return rows, modes


def timed(torch, fn):
    """``(result, seconds)`` of ``fn()`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_geo_train(torch, kernels, serve, cfg, dev):
    """Phase 6: the geo train step at KITTI width, B=8, f32. Returns
    (launch counts of one step, the trained state, the batch)."""
    from cmr_agent_tpu_torch.models.layers import set_dropout_rate
    from cmr_agent_tpu_torch.train import train_geo
    batch = serve.synthetic_batch(cfg, B, dev, seed=0, keys=serve.TRAIN_KEYS)
    step = train_geo.make_geo_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = train_geo.create_geo_state(cfg, dev, seed=0)
    params = sum(p.numel() for p in state.model.parameters())
    step(state, batch, gen)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    metrics, _ = timed(torch, lambda: step(state, batch, gen))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    line("geo_train_launches", per_step=True, **counts)
    for k in ("segment_softmax_attend", "gather_rows", "knn", "segment_sum",
              "segment_softmax_attend_backward"):
        assert counts[k] > 0, (k, counts)
    assert counts["segment_mean_count_image"] == 0, counts
    assert all(torch.isfinite(v) for v in metrics.values()), metrics
    line("geo_train_memory", batch=B, params=params,
         allocated_before_step_gib=f"{before / 2**30:.3f}",
         peak_step_gib=f"{peak / 2**30:.3f}")
    times, losses = [], []
    for _ in range(5):
        m, t = timed(torch, lambda: step(state, batch, gen))
        times.append(t)
        losses.append(m["loss"].item())
    line("geo_train_throughput", batch=B, dropout="on",
         steps_per_s=f"{1 / statistics.median(times):.4f}",
         samples_per_s=f"{B / statistics.median(times):.3f}",
         step_s=",".join(f"{t:.4f}" for t in times),
         loss=",".join(f"{v:.6f}" for v in losses))
    profile_call(torch, lambda: step(state, batch, gen),
                 unprofiled_ms=statistics.median(times) * 1e3,
                 phase="geo_train")

    # twins from the same seed with the kernels and with the plain
    # versions, dropout off: gradients of one forward/backward, then three
    # steps' losses
    twins = {}
    for name in ("kernels", "plain"):
        twin = train_geo.create_geo_state(cfg, dev, seed=0)
        set_dropout_rate(twin.model, 0.0)
        twins[name] = twin
    grads, losses = {}, {}

    def grads_of(model, b):
        model.zero_grad(set_to_none=True)
        model(b, with_loss=True)["loss"].backward()
        return {n: p.grad.detach().clone()
                for n, p in model.named_parameters()}

    # the same plain twin on the cloud nudged in its last bits, four ways:
    # how far such a change already moves each f32 gradient (a conv or
    # dense layer before batch-statistics BatchNorm has a weight gradient
    # of heavily cancelling sums, see tests/test_torch_train_geo.py). One
    # nudge is one draw of that noise, so the floor is the largest of them.
    nudges = [1.0 + s * 2.0 ** -e for e in (23, 22) for s in (1.0, -1.0)]
    nudged = []
    for name, twin in twins.items():
        with (plain_kernels(kernels) if name == "plain"
              else contextlib.nullcontext()):
            twin.model.train()
            grads[name] = grads_of(twin.model, batch)
            if name == "plain":
                nudged = [grads_of(twin.model,
                                   dict(batch, pc=batch["pc"] * f))
                          for f in nudges]
            losses[name] = [step(twin, batch)["loss"].item()
                            for _ in range(3)]
    worst, beyond, worst_vs_floor, outliers = 0.0, 0, 0.0, []
    for n, g in grads["kernels"].items():
        want = grads["plain"][n]
        scale = want.abs().max().item()
        diff = (g - want).abs().max().item()
        floor = max((gn[n] - want).abs().max().item() for gn in nudged)
        # f32 atomics reorder the segment sums of every backward: within
        # 1e-3 max|g|, or within 4x what a last-bit nudge of the input
        # moves. The atomics' order is one more draw of that noise on every
        # run: one run saw a single tensor of 995 at 1.37e-3 max|g|, 6.9x
        # its (then single) nudge, so at most 1% of the tensors may land
        # past the rule, within 2e-3 max|g|.
        tol = max(1e-3 * scale, 4.0 * floor) + 1e-7
        if diff > tol:
            outliers.append((n, diff, scale, floor))
            assert diff <= 2e-3 * scale + 1e-7, outliers[-1]
        worst = max(worst, diff / tol)
        if diff > 1e-3 * scale + 1e-7:
            beyond += 1
            worst_vs_floor = max(worst_vs_floor, diff / floor)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["kernels"],
                                               losses["plain"])]
    # step 1 differs only by atomic order; Adam's normalised update can turn
    # a near-zero gradient element's sign into a full lr step after it
    assert rel[0] <= 1e-5 and max(rel) <= 1e-3, (losses, rel)
    assert len(outliers) <= len(grads["kernels"]) // 100, outliers
    line("geo_train_vs_plain", grad_tensors=len(grads["kernels"]),
         max_diff_over_tol=f"{worst:.3f}", tensors_past_tol=len(outliers),
         tensors_beyond_1e3_of_max=beyond,
         their_max_diff_over_nudge_diff=f"{worst_vs_floor:.3f}",
         loss_kernels=",".join(f"{v:.7f}" for v in losses["kernels"]),
         loss_plain=",".join(f"{v:.7f}" for v in losses["plain"]),
         loss_rel_diff=",".join(f"{v:.2e}" for v in rel))
    return counts, state, batch


def run_agent_train(torch, kernels, cfg, geo_model, batch, dev):
    """Phase 7: BC + PPO agent training on the frozen geo outputs. Returns
    the launch counts of the training run (rollouts + updates)."""
    import numpy as np
    from cmr_agent_tpu_torch.env.buffer import TrajectoryBuffer
    from cmr_agent_tpu_torch.train import train_agent, train_geo
    geo_out = train_geo.make_geo_forward(cfg)(geo_model, batch)
    state = train_agent.create_agent_state(cfg, dev, seed=1)
    rollout = train_agent.make_rollout_fn(cfg)
    update = train_agent.make_ppo_update_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    pbs = cfg.ppo_batch_size

    def minibatches(samples, order):
        for s in range(0, len(order) - pbs + 1, pbs):
            rows = torch.as_tensor(order[s:s + pbs], device=dev)
            yield {k: v.index_select(0, rows) for k, v in samples.items()}

    warm = TrajectoryBuffer(cfg.gamma, cfg.gae_lambda)       # warm-up
    warm.add(rollout(state, geo_out, batch, gen)[0])
    update(state, {k: v[:pbs] for k, v in warm.samples().items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    buf = TrajectoryBuffer(cfg.gamma, cfg.gae_lambda)
    rollout_s, update_s, rewards = [], [], []
    for _ in range(cfg.num_trajectory):
        (traj, final, _), t = timed(
            torch, lambda: rollout(state, geo_out, batch, gen))
        assert torch.isfinite(final).all()
        rollout_s.append(t)
        rewards.append(traj["reward"].mean().item())
        buf.add(traj)
    samples = buf.samples()
    order = np.random.default_rng(cfg.seed).permutation(
        samples["state_2d"].shape[0])
    for mb in minibatches(samples, order):
        metrics, t = timed(torch, lambda: update(state, mb))
        update_s.append(t)
        assert all(torch.isfinite(v) for v in metrics.values()), metrics
    counts = kernels.launch_counts()
    line("agent_train_launches", rollouts=cfg.num_trajectory,
         updates=len(update_s), **counts)
    assert counts["segment_mean_count_image"] == \
        cfg.action_num * cfg.num_trajectory, counts
    assert counts["segment_mean_count_image_project"] == 0, counts
    line("agent_train_time", batch=B, rows=len(order),
         ppo_batch_size=pbs,
         rollout_ms=",".join(f"{t * 1e3:.2f}" for t in rollout_s),
         update_ms_median=f"{statistics.median(update_s) * 1e3:.3f}",
         updates_total_s=f"{sum(update_s):.3f}",
         peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
         mean_reward=",".join(f"{r:.4f}" for r in rewards),
         last_bc_loss=f"{metrics['bc_loss'].item():.5f}",
         last_ppo_loss=f"{metrics['ppo_loss'].item():.5f}")
    profile_call(torch, lambda: rollout(state, geo_out, batch, gen),
                 unprofiled_ms=statistics.median(rollout_s) * 1e3,
                 phase="agent_rollout")

    # an expert_beta=1.0 rollout and one update, each against its twin
    # with the plain kernels, from the same agent weights
    got = {}
    for name in ("kernels", "plain"):
        twin = train_agent.create_agent_state(cfg, dev, seed=2)
        with (plain_kernels(kernels) if name == "plain"
              else contextlib.nullcontext()):
            traj, final, _ = rollout(
                twin, geo_out, batch,
                torch.Generator(device=dev).manual_seed(5), expert_beta=1.0)
            buf = TrajectoryBuffer(cfg.gamma, cfg.gae_lambda)
            buf.add(traj)
            mb = next(minibatches(buf.samples(), order[order < B *
                                                       cfg.action_num]))
            got[name] = (traj, final, update(twin, mb))
    (tk, fk, mk), (tp, fp, mp) = got["kernels"], got["plain"]
    for key in ("action_r", "action_t", "reward"):
        assert torch.equal(tk[key], tp[key]), key
    torch.testing.assert_close(fk, fp, rtol=0, atol=1e-6)
    # the observations' means are f32 sums in another order; the agent
    # carries that difference to its outputs
    torch.testing.assert_close(tk["state_2d"], tp["state_2d"], rtol=1e-5,
                               atol=1e-5)
    diffs = {k: (tk[k] - tp[k]).abs().max().item()
             for k in ("value", "action_logprob", "entropy")}
    assert max(diffs.values()) <= 1e-3, diffs
    for k in train_agent.METRIC_KEYS:
        a, b = mk[k].item(), mp[k].item()
        assert abs(a - b) <= 1e-4 * abs(b) + 1e-5, (k, a, b)
    line("agent_train_vs_plain", expert_beta=1.0,
         state_2d_max_diff=(tk["state_2d"] - tp["state_2d"]).abs().max()
         .item(), **{f"{k}_max_diff": v for k, v in diffs.items()},
         update_loss_kernels=f"{mk['loss'].item():.7f}",
         update_loss_plain=f"{mp['loss'].item():.7f}")
    return counts


WARP_K, CHUNK_P, N_HYPO = 8192, 243, 729
# the flagship setting (runs_r5/README.md, E7)
FLAGSHIP_CFG = dict(cost_volume_unmasked=True, pose_aware_observation=True,
                    obs_bearing_channels=True, policy_aux_state=True,
                    bearing_init=True)
FLAGSHIP_OPTS = dict(hypotheses=13, iter_iters=2, refine_rounds=1,
                     refine_beam=("combo", "mean_valid", "ir_smooth"),
                     beam_score="above50_norm", hypo_score="combo")
# per request: 1 + 13 cost-volume forwards; 13 + 3 fine stages (geo forward
# + episode); 13 + 3 x 2 candidate verifications
ITER_FORWARDS, FINE_STAGES, VERIFICATIONS = 14, 16, 19


def check_compose_kernels(torch, kernels, dev):
    """Phase 8: the shared-data segment sum and the mask-pack compaction
    vs their plain versions at the coarse-to-fine path's shapes."""
    gen, randn, randint = rand_factory(torch, 777, dev)
    rows = {}
    npix, f = IMG_H * IMG_W, F + 2

    # 7. one eval chunk of the cost volume's warp: [feat | score | 1] rows
    #    of the top-K compacted cloud, a pixel id per (hypothesis, row);
    #    about 40% of the rows land, hypothesis 1 sees nothing, ids >= M and
    #    -1 both route out
    data = randn(B, WARP_K, f)
    idx = randint(0, int(npix * 2.5), B, CHUNK_P, WARP_K)
    idx[:, 1] = npix
    idx[:, 2, :100] = -1
    got = kernels.segment_sum_shared(data, idx, npix)
    want = kernels.segment_sum_shared_plain(data, idx, npix)
    # f32 atomics add in another order on every run
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not got[:, 1].any()
    err = (got - want).abs().max().item()
    landed = int(((idx >= 0) & (idx < npix)).sum().item())
    del got, want
    ms = cuda_ms(lambda: kernels.segment_sum_shared(data, idx, npix), 5)
    plain_ms = cuda_ms(lambda: kernels.segment_sum_shared_plain(
        data, idx, npix), 2)
    zero_ms = cuda_ms(lambda: torch.zeros((B, CHUNK_P, npix, f), device=dev),
                      5)
    # the one library call: index_add_ of the rows repeated per hypothesis
    # into the flattened output (a spill row takes the routed-out ones)
    maps = torch.arange(B * CHUNK_P, device=dev).reshape(B, CHUNK_P, 1)
    flat = torch.where((idx >= 0) & (idx < npix), maps * npix + idx.long(),
                       B * CHUNK_P * npix).reshape(-1)
    src = data[:, None].expand(B, CHUNK_P, WARP_K, f).reshape(-1, f)
    library_ms = cuda_ms(lambda: torch.zeros(
        (B * CHUNK_P * npix + 1, f), device=dev).index_add_(0, flat, src), 2)
    del flat, src
    out_bytes = B * CHUNK_P * npix * f * 4
    rows["segment_sum_shared"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        tol="rtol 1e-5 atol 1e-5 (f32 atomics reorder sums)",
        shape=f"[{B},{WARP_K},{f}] x idx [{B},{CHUNK_P},{WARP_K}] -> "
              f"[{B},{CHUNK_P},{npix},{f}] ({out_bytes / 1e9:.2f} GB), "
              f"{landed} of {idx.numel()} rows land; zeroing alone "
              f"{zero_ms:.3f} ms",
        bound=bound(data.numel() * 4 + idx.numel() * 4 + out_bytes,
                    float(landed) * f))
    del data, idx
    torch.cuda.empty_cache()

    # 11. the episode's compaction: overlap counts below and above the
    #     budget, f32 and bf16 features; exact
    pcT = randn(B, 3, N_PT)
    feat = randn(B, N_PT, F)
    timed_case = None
    for frac in (0.3, 0.7):
        mask = (torch.rand(B, N_PT, generator=gen) < frac).to(dev)
        count = mask.sum(dim=1)
        assert (count < RASTER_K).all() if frac < 0.5 \
            else (count > RASTER_K).all()
        for ft in (feat, feat.to(torch.bfloat16)):
            gf, gp = kernels.mask_compact_pack(mask, pcT, ft, RASTER_K)
            wf, wp = kernels.mask_compact_pack_plain(mask, pcT, ft, RASTER_K)
            assert gf.dtype == ft.dtype
            assert torch.equal(gf, wf) and torch.equal(gp, wp), (frac,
                                                                 ft.dtype)
        timed_case = mask, int(count.clamp_max(RASTER_K).sum().item())
    mask, kept = timed_case
    rows["mask_compact_pack"] = dict(
        max_abs_err=0.0, library_ms=None,
        ms=cuda_ms(lambda: kernels.mask_compact_pack(mask, pcT, feat,
                                                     RASTER_K), 20),
        plain_ms=cuda_ms(lambda: kernels.mask_compact_pack_plain(
            mask, pcT, feat, RASTER_K), 5),
        tol="exact (rows are copied); counts below and above k, f32 and bf16",
        shape=f"mask [{B},{N_PT}], feat [{B},{N_PT},{F}] f32 -> k={RASTER_K}, "
              f"{kept} rows kept",
        bound=bound(B * N_PT + kept * (F * 4 + 12)
                    + B * RASTER_K * (F * 4 + 12), 0.0))
    print_rows(rows)
    return rows


def flagship_workload(torch, serve, kitti_config, dtype: str):
    cfg = kitti_config(compute_dtype=dtype, **FLAGSHIP_CFG)
    t0 = time.perf_counter()
    batch, modules, pipeline = serve.build_composed_workload(
        cfg, B, seed=0, **FLAGSHIP_OPTS)
    torch.cuda.synchronize()
    line("composed_workload", dtype=dtype, nlabel=cfg.nlabel,
         eval_chunk=cfg.cost_volume_eval_chunk, raster_mode=cfg.raster_mode,
         build_s=f"{time.perf_counter() - t0:.2f}",
         **{k: v for k, v in FLAGSHIP_OPTS.items() if k != "refine_beam"},
         refine_beam="+".join(FLAGSHIP_OPTS["refine_beam"]))
    return cfg, batch, modules, pipeline


def run_itermodel(torch, kernels, serve, kitti_config):
    """Phase 9: one IterModel forward at KITTI width, B=8, f32."""
    from cmr_agent_tpu_torch.train.train_iter import iter_model_state
    cfg, batch, (geo, iter_model, _), _ = flagship_workload(
        torch, serve, kitti_config, "float32")
    with torch.no_grad():
        st = iter_model_state(geo(batch), batch)

        def forward():
            return iter_model(st, with_loss=False)

        forward()                                             # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        got, _ = timed(torch, forward)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        assert counts["segment_sum_shared"] == N_HYPO // CHUNK_P == 3, counts
        assert sum(counts.values()) == 3, counts
        times = [timed(torch, forward)[1] for _ in range(3)]
        logits = got["cost_volume_logits"]
        assert logits.shape == (B, N_HYPO) and torch.isfinite(logits).all()
        line("itermodel", batch=B, hypotheses=N_HYPO,
             launches_per_forward=counts["segment_sum_shared"],
             forward_ms=",".join(f"{t * 1e3:.2f}" for t in times),
             allocated_before_gib=f"{before / 2**30:.3f}",
             peak_gib=f"{peak / 2**30:.3f}",
             warp_dropped=got["warp_dropped_points"].tolist(),
             logit_min=f"{logits.min().item():.6f}",
             logit_max=f"{logits.max().item():.6f}")
        profile_call(torch, forward,
                     unprofiled_ms=statistics.median(times) * 1e3,
                     phase="itermodel")
        with plain_kernels(kernels):
            want = forward()
    # the warp's per-pixel sums are f32 atomics in another order; the
    # tolerance the CPU tests hold the two JAX warp paths to
    torch.testing.assert_close(logits, want["cost_volume_logits"], rtol=2e-4,
                               atol=2e-5)
    spread = (want["cost_volume_logits"].amax(1)
              - want["cost_volume_logits"].amin(1)).min().item()
    diff = (logits - want["cost_volume_logits"]).abs().max().item()
    same = (got["matrix_i"] - want["matrix_i"]).abs().amax(dim=(1, 2)) < 1e-6
    line("itermodel_vs_plain", max_logit_diff=diff,
         min_logit_spread_per_sample=spread,
         decoded_poses_equal=f"{int(same.sum())}/{B}")
    # the decode is an argmax of marginals: equal where the logits' spread
    # dwarfs the difference
    assert spread > 0
    if spread > 100 * diff:
        assert bool(same.all()), (spread, diff, same)
    return counts, statistics.median(times)


def distinct_margin(torch, scores, tie: float = 1e-4):
    """Per sample, the winner's margin over the best candidate that scores
    differently (more than ``tie`` below it). The hypothesis grid closes on
    itself at a yaw amplitude of pi, so the second cost-volume iteration
    brings several candidates to one pose (serve.spread_random_weights_);
    those score alike to rounding and selecting any of them gives the same
    pose. ``inf`` where all candidates tie."""
    gap = scores.amax(dim=1, keepdim=True) - scores
    return torch.where(gap > tie, gap, torch.full_like(gap, float("inf"))
                       ).amin(dim=1)


def run_composed(torch, kernels, serve, kitti_config, dtype: str):
    """Phase 10 for one compute dtype; returns the launch counts of one
    request."""
    from cmr_agent_tpu_torch.env.environment import (alignment_stats,
                                                     apply_coarse_pose,
                                                     nn_alignment_stats)
    from cmr_agent_tpu_torch.models.cost_volume import decode_topk_yaw_poses
    from cmr_agent_tpu_torch.train.train_iter import iter_model_state
    cfg, batch, (geo, iter_model, agent), pipeline = flagship_workload(
        torch, serve, kitti_config, dtype)
    pipeline(batch)                                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    got, first_s = timed(torch, lambda: pipeline(batch))
    counts = kernels.launch_counts()
    line("composed_launches", dtype=dtype, per_request=True, **counts)
    assert counts["segment_sum_shared"] == 3 * ITER_FORWARDS, counts
    assert counts["segment_softmax_attend"] == 4 * (1 + FINE_STAGES), counts
    assert counts["knn"] == 1 + FINE_STAGES, counts
    assert counts["gather_rows"] > 0, counts
    assert counts["segment_mean_count_image_project"] == \
        FINE_STAGES * cfg.action_num, counts
    assert counts["mask_compact_pack"] == 0, counts       # megatopk episodes
    assert all(counts[k] == 0 for k in TRAINING_KERNELS), counts
    h = FLAGSHIP_OPTS["hypotheses"]
    assert got["pose"].shape == (B, 4, 4)
    assert got["candidate_scores"].shape == (B, h) and got["score"].shape == (B,)
    assert all(torch.isfinite(v).all() for v in got.values())
    R = got["pose"][:, :3, :3]
    eye = torch.eye(3, device=R.device).expand(B, 3, 3)
    torch.testing.assert_close(R @ R.transpose(1, 2), eye, rtol=0, atol=1e-3)

    again, second_s = timed(torch, lambda: pipeline(batch))
    times = [first_s, second_s]
    request_s = statistics.median(times)
    line("composed_throughput", dtype=dtype,
         requests_per_s=f"{1 / request_s:.4f}",
         pairs_per_s=f"{B / request_s:.3f}",
         request_s=",".join(f"{t:.3f}" for t in times),
         peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}")

    # The request's first stages, each with the kernels and with their
    # plain versions on the same input, so that no discrete choice (an
    # overlap flag, the warp's top-K point set, the nominated yaw) is fed
    # from one twin's stage into the next: the geo forward on the batch;
    # the first cost-volume forward on the kernels' geo state; then, for
    # the first nominated candidate, the re-perception of the rebased batch
    # and the episode from the bearing yaw on the kernels' perceived state.
    # f32: the tolerances of phases 4 and 9. bf16: phase 4's, a bf16
    # rounding step carried through the layers.
    atol, rtol = (1e-3, 0.0) if dtype == "float32" else (1e-2, 3e-2)
    feat_keys = ("pc_geo_feat", "img_geo_feat")

    def hold_features(tag, got_out, want_out):
        diffs = {k: (got_out[k].float() - want_out[k].float()
                     ).abs().max().item() for k in feat_keys}
        limits = {k: (1e-4 if dtype == "float32" else
                      atol + rtol * want_out[k].float().abs().max().item())
                  for k in feat_keys}
        assert all(diffs[k] <= limits[k] for k in feat_keys), (tag, diffs,
                                                               limits)
        return diffs

    with torch.no_grad():
        geo_out = geo(batch)
        st = iter_model_state(geo_out, batch)
        logits = iter_model(st, with_loss=False)["cost_volume_logits"]
        coarse = decode_topk_yaw_poses(
            logits, st["R_amplitude"], st["T_amplitude"], cfg.nlabel,
            1)[:, 0] @ st["matrix_accumulated"]
        batch_k = apply_coarse_pose(batch, coarse)
        state = serve.perceive(geo, batch_k)
        final, steps = serve.refine_episode(cfg, agent, state)
        with plain_kernels(kernels):
            geo_plain = geo(batch)
            logits_plain = iter_model(st, with_loss=False)[
                "cost_volume_logits"]
            state_plain = serve.perceive(geo, batch_k)
            final_plain, steps_plain = serve.refine_episode(cfg, agent,
                                                            state)
        geo_diff = hold_features("geo", geo_out, geo_plain)
        fine_diff = hold_features("fine geo", state, state_plain)
        head_diff = (geo_out["pc_overlap_logits"]
                     - geo_plain["pc_overlap_logits"]).abs().max().item()
        logit_diff = (logits - logits_plain).abs().max().item()
        spread = (logits_plain.amax(1) - logits_plain.amin(1)).min().item()
        line("composed_first_stages_vs_plain", dtype=dtype,
             **{f"{k}_diff": v for k, v in geo_diff.items()},
             **{f"fine_{k}_diff": v for k, v in fine_diff.items()},
             pc_overlap_logits_diff=head_diff,
             overlap_flags_differing=int(
                 (state["pc_overlap_pred"] != state_plain["pc_overlap_pred"]
                  ).sum()),
             cost_volume_logit_diff=logit_diff,
             cost_volume_logit_max=logits_plain.abs().max().item(),
             min_logit_spread_per_sample=spread)
        if dtype == "float32":
            # phase 4's 1e-4; the workload's overlap head is scaled up
            assert head_diff <= 1e-4 * serve.OVERLAP_HEAD_GAIN, head_diff
            torch.testing.assert_close(logits, logits_plain, rtol=2e-4,
                                       atol=2e-5)
        else:
            limit = atol + rtol * logits_plain.abs().max().item()
            assert logit_diff <= limit, (logit_diff, limit)
        compared, step_diff = compare_episodes(
            torch, {"steps": steps, "final_pose": final},
            {"steps": steps_plain, "final_pose": final_plain}, atol, rtol)
        line("composed_fine_stage_vs_plain", dtype=dtype, logit_atol=atol,
             logit_rtol=rtol, steps_compared=compared,
             max_logit_diff=step_diff,
             min_step_logit_max=min(w.abs().max().item()
                                    for pair in steps_plain[:compared]
                                    for w in pair),
             final_pose_max_diff=(final - final_plain).abs().max().item())
        fine_s = min(timed(torch, lambda: serve.fine_stage(
            cfg, geo, agent, batch_k))[1] for _ in range(2))

        # the stages alone, in this dtype, on this workload's own modules:
        # the cost-volume forward, the fine stage above, and the
        # verification of that fine stage's final pose
        iter_s = min(timed(torch, lambda: iter_model(st, with_loss=False))[1]
                     for _ in range(2))

        def verify():
            alignment_stats(state, final, cfg.image_h, cfg.image_w)
            nn_alignment_stats(state, final, cfg.image_h, cfg.image_w)

        verify()
        verify_s = min(timed(torch, verify)[1] for _ in range(2))
    parts = (ITER_FORWARDS * iter_s, FINE_STAGES * fine_s,
             VERIFICATIONS * verify_s)
    line("composed_stages", dtype=dtype,
         itermodel_forward_ms=f"{iter_s * 1e3:.2f}",
         fine_stage_ms=f"{fine_s * 1e3:.2f}",
         verification_ms=f"{verify_s * 1e3:.2f}",
         cost_volume_s=f"{parts[0]:.3f}", fine_stages_s=f"{parts[1]:.3f}",
         verification_s=f"{parts[2]:.3f}", stages_sum_s=f"{sum(parts):.3f}",
         request_s=f"{request_s:.3f}")
    profile_call(torch, lambda: pipeline(batch),
                 unprofiled_ms=request_s * 1e3, phase="composed", dtype=dtype)

    with plain_kernels(kernels):
        want = pipeline(batch)
    # The whole request is a chain of discrete choices (overlap thresholds,
    # 160 episode steps, yaw nominations, accept / reject), and f32 atomics
    # add in another order on every run, so two runs of the same kernels
    # already differ wherever a choice was close. Reported: the entries of
    # candidate_scores (z-scores, O(1)) within the tolerance of the plain
    # twin's and of a second run of the kernels, and the selected pose on
    # the samples whose scores all agree, apart for those whose margin over
    # the next differently scoring candidate exceeds the tolerance
    # (refinement and the beam vote add choices the scores do not show).
    # Held in f32 only: in bf16 a request is not reproducible run to run,
    # and the bf16 kernels are held by the first stages above.
    tol = 2e-2 if dtype == "float32" else 0.25

    def agreement(a, b):
        close = (a["candidate_scores"] - b["candidate_scores"]).abs() <= tol
        agree = close.all(dim=1)
        sure = agree & (distinct_margin(torch, b["candidate_scores"]) > tol)
        same = (a["pose"] - b["pose"]).abs().amax(dim=(1, 2)) <= 1e-3
        return dict(entries=int(close.sum()), samples=int(agree.sum()),
                    poses=int((agree & same).sum()), sure=int(sure.sum()),
                    sure_poses=int((sure & same).sum()),
                    max_diff=(a["candidate_scores"] - b["candidate_scores"]
                              ).abs().max().item())

    vs_plain, vs_self = agreement(got, want), agreement(got, again)
    line("composed_vs_plain", dtype=dtype, score_tol=tol,
         entries=B * h, samples=B,
         selection_margins=",".join(
             f"{m:.3f}" for m in distinct_margin(
                 torch, want["candidate_scores"]).tolist()),
         **{f"{k}_plain": v for k, v in vs_plain.items()},
         **{f"{k}_second_run": v for k, v in vs_self.items()})
    if dtype == "float32":
        assert vs_plain["entries"] >= B * h // 2, (vs_plain, vs_self)
        assert vs_plain["entries"] >= vs_self["entries"] - B * h // 4, \
            (vs_plain, vs_self)
        assert vs_plain["poses"] >= 3 * vs_plain["samples"] // 4, vs_plain
        assert vs_plain["sure_poses"] >= 3 * vs_plain["sure"] // 4, vs_plain
    return counts


def run_packed_episode(torch, kernels, serve, kitti_config, mode: str):
    """Phase 11: one serving episode under ``raster_mode`` "pack"/"mega"
    (the mask-pack compaction, then the projection-fused raster) against
    its plain twin. Returns the episode's launch counts."""
    cfg = kitti_config(raster_mode=mode)
    batch, model, agent, episode = serve.build_workload(cfg, B, seed=0)
    episode(batch)                                            # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    final, seconds = timed(torch, lambda: episode(batch))
    counts = kernels.launch_counts()
    line("packed_episode_launches", raster_mode=mode,
         episode_ms=f"{seconds * 1e3:.2f}", **counts)
    assert counts["mask_compact_pack"] == 1, counts
    assert counts["segment_mean_count_image_project"] == cfg.action_num, counts
    assert final.shape == (B, 4, 4) and torch.isfinite(final).all()
    got = serve.serve_episode(model, agent, cfg, batch)
    with plain_kernels(kernels):
        want = serve.serve_episode(model, agent, cfg, batch)
    steps, diff = compare_episodes(torch, got, want, atol=1e-3)
    line("packed_episode_vs_plain", raster_mode=mode, logit_atol=1e-3,
         steps_compared=steps, max_logit_diff=diff,
         final_pose_max_diff=(got["final_pose"] - want["final_pose"]
                              ).abs().max().item())
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from cmr_agent_tpu_torch import serve
    from cmr_agent_tpu_torch.config import kitti_config
    from cmr_agent_tpu_torch.ops import build, kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    line("device", name=repr(torch.cuda.get_device_name(0)),
         count=torch.cuda.device_count(), nvidia_smi=repr(smi),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    kernels.library()
    line("build", seconds=f"{time.perf_counter() - t0:.2f}",
         library=build.library_path())

    rows = check_kernels(torch, kernels, dev)
    counts, _ = run_path(torch, kernels, serve, kitti_config, "float32")
    run_path(torch, kernels, serve, kitti_config, "bfloat16")

    train_rows, _ = check_train_kernels(torch, kernels, dev)
    rows.update(train_rows)
    geo_counts, geo_state, train_batch = run_geo_train(
        torch, kernels, serve, kitti_config(), dev)
    agent_counts = run_agent_train(torch, kernels, kitti_config(),
                                   geo_state.model, train_batch, dev)
    del geo_state, train_batch
    torch.cuda.empty_cache()

    rows.update(check_compose_kernels(torch, kernels, dev))
    run_itermodel(torch, kernels, serve, kitti_config)
    torch.cuda.empty_cache()
    composed_counts = run_composed(torch, kernels, serve, kitti_config,
                                   "float32")
    torch.cuda.empty_cache()
    run_composed(torch, kernels, serve, kitti_config, "bfloat16")
    torch.cuda.empty_cache()
    pack_counts = run_packed_episode(torch, kernels, serve, kitti_config,
                                     "pack")
    run_packed_episode(torch, kernels, serve, kitti_config, "mega")
    # each kernel's launches on the path that runs it: the serving episode,
    # one geo train step, the agent training run, one composed request, or
    # the "pack" episode
    counts.update({k: geo_counts[k] for k in ("segment_sum",
                                               "segment_softmax_attend_backward")})
    counts["segment_mean_count_image"] = agent_counts["segment_mean_count_image"]
    counts["segment_sum_shared"] = composed_counts["segment_sum_shared"]
    counts["mask_compact_pack"] = pack_counts["mask_compact_pack"]

    sources = {
        "segment_softmax_attend": ("segment_softmax.cu", 126),
        "gather_rows": ("gather_rows.cu", 489),
        "knn": ("knn.cu", 395),
        "segment_mean_count_image_project": ("raster.cu", 1579),
        "segment_sum": ("segment_sum.cu", 258),
        "segment_softmax_attend_backward": ("segment_softmax_backward.cu",
                                            145),
        "segment_mean_count_image": ("raster_image.cu", 685),
        "segment_sum_shared": ("segment_sum_shared.cu", 320),
        "mask_compact_pack": ("mask_pack.cu", 1467),
    }
    summary = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"cmr_agent_tpu_torch/csrc/{src}",
         "replaces": f"cmr_agent_tpu/ops/pallas_kernels.py:{ln}",
         "launches": counts[name], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
        for name, (src, ln) in sources.items() for r in (rows[name],)]}
    print(json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
