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
   kernels by device time).

The last lines are the kernels' JSON summary, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Needs a CUDA card: without one it exits
non-zero before printing any result.
"""

from __future__ import annotations

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


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch, kernels, dev):
    """Phase 3: every kernel vs its plain version at the serving shapes."""
    gen = torch.Generator().manual_seed(1234)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).to(dev)

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

    for name, r in rows.items():
        line("kernel", name=name, shape=repr(r["shape"]), tol=repr(r["tol"]),
             max_abs_err=r["max_abs_err"], kernel_ms=f"{r['ms']:.5f}",
             plain_ms=f"{r['plain_ms']:.5f}",
             bound_us=f"{r['bound'][0] * 1e3:.2f}({r['bound'][1]})",
             library_ms=("none" if r["library_ms"] is None
                         else f"{r['library_ms']:.5f}"))
    return rows


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
    assert all(n > 0 for n in counts.values()), counts
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


PORT_KERNEL_NAMES = ("channel_max_kernel", "softmax_accumulate_kernel",
                     "normalise_kernel", "gather_rows_kernel", "knn_kernel",
                     "raster_project_kernel", "raster_finalise_kernel")


def profile_episode(torch, serve, model, agent, cfg, batch) -> None:
    """Device time of one episode by kernel (torch.profiler, CUPTI): the
    device's busy share of the wall time and the port kernels' share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve.serve_episode(model, agent, cfg, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    per_name = {}
    for e in prof.key_averages():     # device-side rows: kernels, copies
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        per_name[e.key] = per_name.get(e.key, 0.0) + dev_us / 1e3
    device_ms = sum(per_name.values())
    ours = sum(ms for k, ms in per_name.items()
               if any(n in k for n in PORT_KERNEL_NAMES))
    line("profile", dtype=cfg.compute_dtype, wall_ms=f"{wall_ms:.3f}",
         device_ms=f"{device_ms:.3f}",
         device_busy_share=(f"{device_ms / wall_ms:.3f}" if device_ms
                            else "not measured"),
         port_kernels_ms=f"{ours:.3f}")
    for k, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:12]:
        line("profile_top", ms=f"{ms:.3f}", name=repr(k[:90]))


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

    sources = {
        "segment_softmax_attend": ("segment_softmax.cu", 126),
        "gather_rows": ("gather_rows.cu", 489),
        "knn": ("knn.cu", 395),
        "segment_mean_count_image_project": ("raster.cu", 1579),
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
