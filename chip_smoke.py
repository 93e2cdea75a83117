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
   rollout and one update against their plain-kernel twins.

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
    assert all(counts[k] == 0 for k in TRAINING_KERNELS), counts
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
PORT_KERNEL_NAMES = ("channel_max_kernel", "softmax_accumulate_kernel",
                     "normalise_kernel", "gather_rows_kernel", "knn_kernel",
                     "raster_project_kernel", "raster_finalise_kernel",
                     "segment_sum_kernel", "softmax_backward_kernel",
                     "raster_image_kernel")


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

    # the same plain twin on the cloud nudged by one part in 2^23: how far a
    # last-bit change already moves each f32 gradient (a conv or dense
    # layer before batch-statistics BatchNorm has a weight gradient of
    # heavily cancelling sums, see tests/test_torch_train_geo.py)
    nudged = dict(batch, pc=batch["pc"] * (1.0 + 2.0 ** -23))
    for name, twin in twins.items():
        with (plain_kernels(kernels) if name == "plain"
              else contextlib.nullcontext()):
            twin.model.train()
            grads[name] = grads_of(twin.model, batch)
            if name == "plain":
                grads["nudged"] = grads_of(twin.model, nudged)
            losses[name] = [step(twin, batch)["loss"].item()
                            for _ in range(3)]
    worst, beyond, worst_vs_floor = 0.0, 0, 0.0
    for n, g in grads["kernels"].items():
        want = grads["plain"][n]
        scale = want.abs().max().item()
        diff = (g - want).abs().max().item()
        floor = (grads["nudged"][n] - want).abs().max().item()
        # f32 atomics reorder the segment sums of every backward: within
        # 1e-3 max|g|, or within 4x what a last-bit nudge of the input moves
        tol = max(1e-3 * scale, 4.0 * floor) + 1e-7
        assert diff <= tol, (n, diff, scale, floor)
        worst = max(worst, diff / tol)
        if diff > 1e-3 * scale + 1e-7:
            beyond += 1
            worst_vs_floor = max(worst_vs_floor, diff / floor)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["kernels"],
                                               losses["plain"])]
    # step 1 differs only by atomic order; Adam's normalised update can turn
    # a near-zero gradient element's sign into a full lr step after it
    assert rel[0] <= 1e-5 and max(rel) <= 1e-3, (losses, rel)
    line("geo_train_vs_plain", grad_tensors=len(grads["kernels"]),
         max_diff_over_tol=f"{worst:.3f}",
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
    # each kernel's launches on the path that runs it: the serving episode,
    # one geo train step, or the agent training run
    counts.update({k: geo_counts[k] for k in ("segment_sum",
                                               "segment_softmax_attend_backward")})
    counts["segment_mean_count_image"] = agent_counts["segment_mean_count_image"]

    sources = {
        "segment_softmax_attend": ("segment_softmax.cu", 126),
        "gather_rows": ("gather_rows.cu", 489),
        "knn": ("knn.cu", 395),
        "segment_mean_count_image_project": ("raster.cu", 1579),
        "segment_sum": ("segment_sum.cu", 258),
        "segment_softmax_attend_backward": ("segment_softmax_backward.cu",
                                            145),
        "segment_mean_count_image": ("raster_image.cu", 685),
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
