#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cmr_agent_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase geo_train --repeat 3   # one phase alone
    python3 chip_smoke.py --phase segment_sums           # kernels 5 and 7
    python3 chip_smoke.py --phase knn_raster             # kernels 3 and 4
    python3 chip_smoke.py --phase softmax_image          # kernels 1 and 6a
    python3 chip_smoke.py --phase compact_pack           # kernels 11 and 8
    python3 chip_smoke.py --phase factored               # kernel 6b
    python3 chip_smoke.py --phase eval                   # the E7 evaluation
    python3 chip_smoke.py --phase export                 # the serving export
    python3 chip_smoke.py --phase train                  # the training CLIs
    python3 chip_smoke.py --phase inputs                 # KITTI / nuScenes
    python3 chip_smoke.py --phase modules                # the last modules

Phases, one line each (a failure in any phase raises and exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``cmr_agent_tpu_torch/csrc`` (into
   ``build/cuda/``) and report the build time;
3. each kernel at the serving path's KITTI shapes against its plain
   PyTorch version on the card (the knn equal in full order, the raster's
   int8 means bit-equal), with its time, the plain version's time,
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
   ``torch.autograd`` of the plain forward, with the same timings; the
   segment sum also bit-equal to a second launch, on the bucketing's edge
   cases (one segment taking 90% of the rows, M = 1, empty end segments,
   every row routed out, samples drawn differently) too, with its device
   time;
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
   the cost volume's warp, with a dead hypothesis, bit-equal to a second
   launch and on the segment sum's edge cases as hypotheses too; and the
   mask-pack compaction bit-equal with counts below, at and above its
   budget, empty and full masks, k > N, f32, bf16 and odd-F bf16 rows,
   also launched into outputs pre-filled with a non-zero byte, which it
   must overwrite) at their KITTI shapes against their plain versions,
   with the same timings (also alone with ``--phase compact_pack``);
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
    twin beside a second run of the kernels themselves (the port's kernels
    on this path add in fixed orders, but PyTorch's own scatters and
    cuDNN may not: the line says whether the two runs gave the same bits;
    held in f32, reported in bf16);
11. one serving episode under ``raster_mode`` "pack" and one under "mega"
    against their plain twins (one mask-pack launch each);
12. the fused dense chain at the KITTI shapes of the fused eval stacks
    (row-major: the geo model's MiniPointNet and ResDenseBlock chains;
    channel-major: the agent's four 3-D stages, once with ``out_max``), f32
    and bf16, against the plain version, with the port's unfused eval
    module on the same input as the library time;
13. the fused serving path (``fused_stacks`` "all" and "agent", f32 and
    bf16 + int8): launch counts of one episode, pairs/s beside the
    unfused workload's (the three timed in turns), a profile of each, the
    episode against its plain-kernel twin and, in f32, the fused geo
    outputs against the unfused model on the same weights;
14. the uncompacted eval rasters, the fresh overlap head centred on the
    batch's median point: one eval episode each under ``raster_mode``
    "compact" (f32, bf16 + int8), "flat" and "topk" (bf16 + int8) against
    its plain twin on the same perceived state; then the compacting raster
    (counts exact, int8 sums bit-equal, f32 / bf16 rtol 1e-5, every mode
    bit-equal across launches) in f32, bf16 and int8 on the f32 "compact"
    episode's busiest call (timed, ``index_add_`` the library call) and on
    its edge cases (every row routed out, timed; one pixel; ids in reverse
    order; N a multiple of neither 512 nor 4096; B = 1), its gradient, the
    int8 pixel-id raster on the same call, and each call of both "compact"
    episodes in its own mode (also alone with ``--phase compact_pack``);
15. the factored image raster (kernel 6b: the pixel-id band kernel
    writing sums; also alone, with the three raster probes, with ``--phase
    factored``) in f32 and bf16 on the raster probe's rows and on a
    training episode's ids, with the count column appended (F + 1) and
    without it, against its plain version (counts exact, sums rtol 1e-5
    atol 1e-5, the same bits on a second launch), its backward against
    autograd of the plain version, with the same timings and
    ``index_add_`` as the library call; the factored mean bit-equal to the
    flat mean on the same ids and against its plain ones-column version
    (counts exact, means rtol 1e-5 atol 1e-5; ``[factored_mean]``); then
    the measuring
    tools through their ``main``: ``tools.raster_probe`` (every row in the
    frame, a quarter valid-first, a quarter scattered; the factored
    kernel's launches are counted over these three runs and must be 318),
    ``tools.episode_trace`` (bf16, 3 episodes) and ``tools.train_probe``
    (10 steps per variant), each JSON on a ``[raster_probe]``,
    ``[episode_trace]`` or ``[train_probe]`` line;
16. the exact knn and the projection-fused raster (kernels 3 and 4, also
    alone with ``--phase knn_raster``): the knn equal to its plain version
    in full order and bit-equal across launches at the serving shape, k 1,
    8, 16, 32 at N = 1000 and 4096 with M != N, on exact duplicates and
    on the geo forward's own call; the raster in f32, bf16 and int8 (counts
    exact, int8 means bit-equal, f32 / bf16 rtol 1e-5 atol 1e-6) on phase
    3's cloud, counts 0 and K, every row on one pixel, every row behind the
    camera, every pixel filled, a 37x101 frame and an all-zero channel,
    then on the 10 calls of one bf16 + int8 episode; with each kernel's
    wrapper, device and host times and its bound in each mode; then both
    wrappers raising, with no launch, on shapes the kernels cannot take;
17. the segment softmax-attend and the pixel-id raster (kernels 1 and 6a,
    also alone with ``--phase softmax_image``): kernel 1 within rtol 1e-5
    atol 1e-6 of its plain version (gmax equal), bit-equal across two
    launches, a bf16 call equal to the f32 call on the widened operands,
    on the segment sums' id cases (one segment taking 90% of the rows, M =
    1, empty ends, every row routed out by -1 and by >= M, samples drawn
    differently) at full width, F = 3 and F = 66, an underflowing segment,
    then on the 4 calls of one f32 and one bf16 geo forward, with its
    backward on the new residuals; kernel 6a in f32, bf16 and int8 (counts
    exact, int8 means bit-equal, f32 / bf16 rtol 1e-5 atol 1e-6, every
    mode bit-equal across launches and to kernel 4 on the same rows) on
    phase 16's raster cases, timed at the training shape, on the 40 calls
    of one agent-training run and the 10 of one "flat" bf16 + int8
    episode; a profile of one int8 call (the port's kernels only); then
    both wrappers raising, with no launch, on what they cannot take;
18. the flagship evaluation at the committed trained weights (also alone
    with ``--phase eval``): each weight export's sha256 against
    ``weights/manifest.json``, its leaves, bytes and load time
    (``[weights]``); the sha256 of E7's 64 test scenes as this host builds
    them against the JAX package's split's (``[eval_split]``); the first batch of E7's test split (8 scenes) in f32
    through ``cli.test_agent``'s path with the kernels and with their plain
    versions, each candidate's coarse pose, episode (phase 4's gate), final
    pose, verification statistics and the selections held
    (``[eval_twin]``); one bf16 E7 batch's launches per kernel, time and
    profile (``[eval_launches]``, ``[profile] phase=eval``); the E7 command
    of ``runs_r5/README.md`` through ``cli.test_agent.main`` (64 scenes,
    bf16, batch 8, K = 13, the re-voted 3-member beam): registration recall,
    the ceilings, the median errors, the steady time per pair, peak memory
    and its launches (8 times one batch's), beside the JAX package's
    published accuracy (``[eval_agent]``), and the per-scene ``--save-mat``
    fields as one JSON line (``[eval_scenes]``); then ``cli.test_geo`` on 8
    scenes of the split in f32 (``[eval_geo]``);
19. the serving export (``train/export.py``; also alone with ``--phase
    export``, which adds the composed pipeline at the E7 options on the
    trained weights in bf16 + int8 at E7's K = 13 hypotheses,
    ``--hypotheses`` another): the geo forward and the episode of phase 4's
    workload in f32, in bf16 + int8 and under ``fused_stacks`` "all" (bf16
    + int8), each workload exported on the card by a process of its own
    (``--export-worker``), while a fresh process that imports ``torch`` and
    the port only loads each artifact as it is written; once all of that
    untimed work is done (``[export_untimed]``), each exporter in turn,
    alone on the card and the host: the export's and the load's seconds,
    the artifact's bytes and nodes, its ``cmr::`` nodes, which must equal
    the launches of one eager run of the traced body, its plain-version
    nodes and its tensors made from host data, none of either
    (``[export]``); the loaded artifact captured as one CUDA graph (the
    memory its pool reserved) and replayed, bit-equal to the traced body
    (``[export_twin]``); per workload, its rate eager and captured in turns
    (eager, captured, captured, eager), then one uncaptured run of the
    loaded module, each with the device's busy share and peak memory
    (``[captured]``); the geo forward replayed again after the episode was
    captured, bit-equal (``[export_replay]``); last the fresh process calls
    each artifact on the exporters' inputs, bit-equal to their replays, and
    the first again after every later capture (``[export_load]``);
20. the training entry points (also alone with ``--phase train``), at
    KITTI width and depth, B = 8, f32, random weights, the synthetic
    dataset (16 train and 8 val scenes), each CLI through its ``main`` with
    its stdout relayed, at the CLIs' own precision (TF32 matmuls and
    convolutions). First ``cli.train_iter --steps 3`` without ``--remat``
    in a process of its own (``--iter-cli-worker``; the whole run starts it
    before phase 1: the step's ~69 GiB peak wants the card to itself) and
    with ``--remat`` here (``[train_iter_cli]``: step ms, peak memory);
    ``cli.train_geo`` for 6 steps eager and 12 at ``--steps-per-dispatch
    2`` (one captured CUDA graph, whose replays launch through no wrapper;
    a stop file after its sixth call), then ``--resume`` from the stop
    file's checkpoint, the step continuing (``[train_geo_cli]``: the median
    steps/s of the 5 eager steps and of the 5 replays after the capture,
    peak memory, launches per step, and the busy share of the eager step
    beside the graph's, ``[train_geo_busy]``); ``make_geo_multi_step(S=2)``
    against two eager steps on the same batches and generator state
    (losses rtol 1e-5, eval loss 1e-3, whether the parameters came out
    bit-equal, ``[geo_multi_twin]``); ``cli.train_agent --steps 4`` (32 PPO
    updates) plain and with ``--expert-beta-frac 0.5``
    (``[train_agent_cli]``); one IterModel train step at B = 8 under
    ``cost_volume_remat`` (two warps) against its plain-kernel twin (logits
    rtol 2e-4, phase 6's gradient rule, ``[iter_train_twin]``); the geo and
    the IterModel train step at TF32 against the same step in full f32, the
    CLIs' precision against the twins' (``[tf32_twin]``); a 6-DoF rollout +
    update (phase 7's gate) and eval episode (phase 4's) against their
    twins (``[six_dof]``); a bf16 + int8 eval episode under
    ``obs3d_source="compact"`` in the nc and the cn layout against its twin
    and each other, with the agent's device time on the compacted and the
    full observation (``[obs3d_compact]``).

21. the reference's own inputs (also alone with ``--phase inputs``): a
    KITTI odometry tree (sequences 00, 09, 10, 8 frames, both cameras,
    376 x 1241 images, ``[4, 120000]`` velodyne dumps, sequence 00's
    calib) and a nuScenes pre-dump (16 train and 16 test triplets of a
    ``[4, 34720]`` cloud, a 160 x 320 image and K) written from seed 0
    (``[inputs_trees]``); the first 8 test samples of each against the
    digests the CPU tests hold (``[inputs_split]``); ``data.smoke
    --feed-rate 20`` on each train split (lengthened to 200 samples by
    links) beside the captured geo step's samples/s, with the steady rate
    after the loader's window (``[inputs_feed]``); the committed weight exports of E7 written as
    reference ``.pth`` files and loaded through the CLIs' loader, bit-equal
    to the exports' load (``[pth_import]``); ``cli.train_geo --dataset
    kitti`` (6 eager steps) and ``--dataset nuscenes`` (3) at B = 8 with
    steps/s, busy share, peak memory, launches and the host's time between
    steps, the nuScenes step then under phase 6's gate on a batch of its
    tree (``[train_geo_kitti]``, ``[train_geo_nuscenes]``); phase 4's serving
    path at the nuScenes width (40 x 80) on the nuScenes test split in f32
    and bf16 + int8 against its plain twin, ``cli.test_geo --dataset
    nuscenes --max-batches 1`` with kernel 7's launches and one IterModel
    forward against its plain twin (``[nuscenes_serve]``,
    ``[nuscenes_test_geo]``, ``[nuscenes_itermodel_vs_plain]``);
    ``cli.test_agent --dataset kitti --max-batches 1`` at E7's flags in
    bf16 on the ``.pth`` files (``[eval_kitti]``); the geo train step with
    ``use_gnn_embedding`` at KITTI width, B = 8, on the KITTI tree's host
    knn, under phase 6's gate (``[gnn_geo]``).

22. the last modules (also alone with ``--phase modules``), each part's
    seconds on ``[modules_part]``: PointNet++'s SSG segmentation stack
    (SA 1024/256/64/16, FP back to 40960 points) at B = 8 on a KITTI
    cloud, forward and backward ms, peak memory and the gather kernel's
    launches, the kernels twin against the plain twin (``[pointnet]``,
    ``[pointnet_vs_plain]``); FPS 40960 -> 1280 and the 1-NN assignment
    equal to ``native/``'s host versions on a 1/8 m grid, the ball query
    and the segment ops against the CPU, each op's ms
    (``[sampling_ops]``); ``initialize`` at world size 1 over NCCL with
    the dp geo step bit-equal to ``make_geo_train_step``, then two gloo
    ranks on this card (started at the phase's start) with the dp step at
    B = 8 against the single-process step and the sp message shards
    against the unsharded message (``[parallel]``); ``diagnose_agent
    --full`` at geo_45 / agent_45, pool 8 (``[diagnose]``); the int8
    probe with the stack share from this card's trace (``[int8_probe]``);
    the visualiser's expert and untrained rollouts (``[visualize]``).

The last lines are the kernels' JSON summary, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Needs a CUDA card: without one it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

from cmr_agent_tpu_torch.tools.segment_turns import (
    agent_raster_calls, capture, capture_calls, flat_episode_raster_calls,
    raster_cloud, train_raster_ids)
from cmr_agent_tpu_torch.utils.profiling import cuda_ms, profile_device

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 (non-tensor-core)
# rate; the bound of a kernel is the larger of bytes/BW and ops/rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12     # dense tensor-core rate
B, N_PT, N_NODE, N_PROXY, F, KNN_K = 8, 40960, 1280, 256, 64, 16
RASTER_K, IMG_H, IMG_W = 20480, 40, 128


def line(tag: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{tag}] {body}", flush=True)


def rand_factory(torch, seed: int, dev):
    """``(gen, randn, randint)`` drawing on the CPU from ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).to(dev)
    return gen, randn, randint


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch, kernels, dev):
    """Phase 3: every kernel vs its plain version at the serving shapes."""
    gen, randn, randint = rand_factory(torch, 1234, dev)
    rows = {}

    # 1. segment softmax-attend: 3x points -> nodes, 1x nodes -> proxies,
    #    f32 and bf16 operands (the bf16 serving path's)
    for n, m in ((N_NODE, N_PROXY), (N_PT, N_NODE)):
        attn, values = randn(B, n, F, scale=2.0), randn(B, n, F)
        idx = randint(0, m, B, n)
        for dt in (torch.float32, torch.bfloat16):
            a, v = attn.to(dt), values.to(dt)
            got = kernels.segment_softmax_attend(a, v, idx, m)
            want = kernels.segment_softmax_attend_plain(a, v, idx, m)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            assert torch.equal(kernels.segment_softmax_attend(a, v, idx, m),
                               got)
            err = (got - want).abs().max().item()
            fn = functools.partial(kernels.segment_softmax_attend, a, v,
                                   idx, m)
            tag = "" if dt == torch.float32 else "_bf16"
            rows[f"segment_softmax_attend{tag}"] = dict(
                max_abs_err=err, ms=cuda_ms(fn, 20),
                device_ms=kernel_device_ms(fn, SOFTMAX_KERNEL_NAMES),
                plain_ms=cuda_ms(functools.partial(
                    kernels.segment_softmax_attend_plain, a, v, idx, m), 5),
                library_ms=None,
                tol="rtol 1e-5 atol 1e-6 (f32 sums in a fixed order, expf); "
                    "same bits on a second launch",
                shape=f"[{B},{n},{F}] {str(dt)[6:]} -> [{B},{m},{F}]",
                bound=softmax_bound(a, m))

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

    # 3. knn over the nodes: equal to the plain version in full order
    xyz = randn(B, N_NODE, 3, scale=20.0)
    rows["knn"] = knn_row(torch, kernels, xyz, xyz, KNN_K)

    # 4. projection-fused raster: valid-first clouds, some behind the camera
    cloud = raster_cloud(B, RASTER_K, F, IMG_H, IMG_W, dev, gen)
    modes = raster_modes(torch, kernels, *cloud, IMG_H, IMG_W, "phase3")
    r = modes["f32"]
    assert r["landed"] > 0.3 * int(cloud[3].sum()), r["landed"]
    rows["segment_mean_count_image_project"] = dict(
        r, tol="counts exact; int8 means bit-equal; f32, bf16 means rtol "
               "1e-5 atol 1e-6 (f32 sums in another order); same bits on a "
               "second launch",
        shape=f"[{B},3,{RASTER_K}] F={F} {IMG_H}x{IMG_W} f32, "
              f"{int(cloud[3].sum())} valid rows, {r['landed']} in the frame")

    print_rows(rows)
    return rows


KNN_KERNEL_NAMES = ("knn_kernel",)
RASTER_KERNEL_NAMES = ("raster_prepass_kernel", "raster_band_kernel")
# kernel 4's operand modes: (name, compute dtype)
RASTER_MODES = (("f32", None), ("bf16", "bfloat16"), ("int8", "int8"))


def knn_row(torch, kernels, xyz, query, k: int, timed: bool = True):
    """Kernel 3 against its plain version on one call: ``torch.equal``,
    neighbours in full order, and the same bits on a second launch; with
    ``timed`` the wrapper's, device and plain times and the bound (the
    inputs read and the output written once; 7 f32 operations a
    distance), else the wrapper's time over 3 calls."""
    got = kernels.knn(xyz, query, k)
    assert torch.equal(got, kernels.knn_plain(xyz, query, k)), (
        xyz.shape, query.shape, k)
    assert torch.equal(kernels.knn(xyz, query, k), got)
    b, n, _ = xyz.shape
    m = query.shape[1]
    row = dict(max_abs_err=0.0, library_ms=None,
               tol="equal to the plain version in full order; same bits "
                   "on a second launch",
               shape=f"[{b},{n},3]x[{b},{m},3] k={k}")

    def fn():
        return kernels.knn(xyz, query, k)
    if not timed:
        return dict(row, ms=cuda_ms(fn, 3))
    nbytes = b * (n + m) * 3 * 4 + b * m * k * 4
    return dict(row, ms=cuda_ms(fn, 20),
                device_ms=kernel_device_ms(fn, KNN_KERNEL_NAMES),
                host_us=host_us(torch, fn),
                plain_ms=cuda_ms(lambda: kernels.knn_plain(xyz, query, k), 5),
                bound=bound(nbytes, 7.0 * b * m * n))


def raster_bound(pcT, feat, counts, landed: int, h: int, w: int,
                 mode: str):
    """Kernel 4's bound: the valid rows' xyz, the landing rows' features
    (int8: all K rows', which the absmax reads) in their given dtype, ab,
    counts and the output, each once; 20 operations a valid row's
    projection and F + 1 adds a landing row."""
    b, _, k = pcT.shape
    f = feat.shape[-1]
    valid = int(counts.clamp(0, k).sum())
    feat_rows = b * k if mode == "int8" else landed
    nbytes = (valid * 3 * 4 + feat_rows * f * feat.element_size()
              + b * 13 * 4 + b * h * w * (f + 1) * 4)
    return bound(nbytes, 20.0 * valid + (f + 1.0) * landed)


def raster_modes(torch, kernels, pcT, feat, ab, counts, h: int, w: int,
                 label: str, timed: bool = True):
    """Kernel 4 against its plain version in f32, bf16 and int8 on one
    input: counts exact, int8 means bit-equal (exact integer sums, the same
    scale), f32 / bf16 means within rtol 1e-5 atol 1e-6 (f32 sums in
    another order), every mode the same bits on a second launch (each
    pixel's rows are added in an order fixed by the ids).
    With ``timed`` each mode's wrapper, device, host and plain times and
    bound. Returns ``{mode: row}``; one ``[raster_mode]`` line a mode."""
    out = {}
    for mode, dt in RASTER_MODES:
        args = (pcT, feat, ab, counts, h, w,
                None if dt is None else getattr(torch, dt))
        gm, gc = kernels.segment_mean_count_image_project(*args)
        wm, wc = kernels.segment_mean_count_image_project_plain(*args)
        assert torch.equal(gc, wc), (label, mode)
        err = (gm - wm).abs().max().item() if gm.numel() else 0.0
        if mode == "int8":
            assert torch.equal(gm, wm), (label, mode, err)
        else:
            torch.testing.assert_close(gm, wm, rtol=1e-5, atol=1e-6)
        gm2, gc2 = kernels.segment_mean_count_image_project(*args)
        same = bool(torch.equal(gm2, gm) and torch.equal(gc2, gc))
        assert same, (label, mode)
        r = dict(max_abs_err=err, same_bits=same, landed=int(wc.sum()),
                 library_ms=None)
        del gm, gc, wm, wc, gm2, gc2

        def fn():
            return kernels.segment_mean_count_image_project(*args)
        if timed:
            r.update(ms=cuda_ms(fn, 20),
                     device_ms=kernel_device_ms(fn, RASTER_KERNEL_NAMES),
                     host_us=host_us(torch, fn),
                     plain_ms=cuda_ms(lambda: kernels.
                                      segment_mean_count_image_project_plain(
                                          *args), 5),
                     bound=raster_bound(pcT, feat, counts, r["landed"], h, w,
                                        mode))
        else:
            r["ms"] = cuda_ms(fn, 3)
        line("raster_mode", case=label, mode=mode, feat_dtype=str(
            feat.dtype).replace("torch.", ""), landed=r["landed"],
             max_abs_err=err, same_bits=same, kernel_ms=f"{r['ms']:.5f}",
             **({} if not timed else dict(
                 device_ms=fmt_ms(r["device_ms"]),
                 host_us=f"{r['host_us']:.1f}",
                 plain_ms=f"{r['plain_ms']:.5f}",
                 bound_us=f"{r['bound'][0] * 1e3:.2f}({r['bound'][1]})")))
        out[mode] = r
    return out


def print_rows(rows) -> None:
    for name, r in rows.items():
        device = {k: fmt_ms(r[k]) for k in ("device_ms", "host_us")
                  if k in r}
        if "same_bits" in r:
            device["same_bits"] = r["same_bits"]
        line("kernel", name=name, shape=repr(r["shape"]), tol=repr(r["tol"]),
             max_abs_err=r["max_abs_err"], kernel_ms=f"{r['ms']:.5f}",
             **device, plain_ms=f"{r['plain_ms']:.5f}",
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


def run_path(torch, kernels, serve, kitti_config, dtype: str, batch=None,
             profile: bool = True):
    """Phase 4 for one compute dtype; returns (launch counts, pairs/s).
    ``kitti_config`` makes the configuration; ``batch`` (default: the
    workload's synthetic one) is what the episodes read."""
    cfg = kitti_config(compute_dtype=dtype)
    t0 = time.perf_counter()
    synthetic, model, agent, episode = serve.build_workload(cfg, B, seed=0)
    batch = synthetic if batch is None else batch
    torch.cuda.synchronize()
    line("workload", dtype=dtype, raster_int8=cfg.raster_int8,
         raster_topk=cfg.episode_raster_topk(),
         width=f"{cfg.image_h}x{cfg.image_w}",
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
    assert all(counts[k] == 0 for k in TRAINING_KERNELS + COMPOSE_KERNELS
               + FUSION_KERNELS), counts
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

    if profile:
        profile_episode(torch, serve, model, agent, cfg, batch)
    if profile and dtype == "float32":
        check_kernel_rows(torch, lambda: episode(batch))
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
FUSION_KERNELS = ("fused_dense_chain", "fused_dense_chain_cn",
                  "segment_sum_count_image_compact")
PORT_KERNEL_NAMES = ("softmax_max_kernel", "softmax_bucket_kernel",
                     "softmax_reduce_kernel", "gather_rows_kernel",
                     "knn_kernel", "raster_prepass_kernel",
                     "raster_band_kernel",
                     "segment_bucket_kernel", "segment_reduce_kernel",
                     "softmax_backward_kernel", "segment_sum_shared_kernel",
                     "mask_rank_kernel", "mask_pack_kernel",
                     "chain_mma_kernel", "chain_f32_kernel")


def profile_episode(torch, serve, model, agent, cfg, batch) -> None:
    """Device time of one episode by kernel (see :func:`profile_call`)."""
    profile_call(torch, lambda: serve.serve_episode(model, agent, cfg, batch),
                 dtype=cfg.compute_dtype)


def check_kernel_rows(torch, fn) -> None:
    """``[profile_rows]``: the card's rows of one profiled call of ``fn``
    as ``utils.profiling.kernel_rows`` reads them from the raw events (what
    every profile of this script prints) against ``key_averages``' device
    rows of the same profile: the same names and counts, times within
    1e-6 relative (``key_averages`` takes each row's ends in f64 µs from
    the trace's start)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cmr_agent_tpu_torch.utils.profiling import kernel_rows
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fast = kernel_rows(prof.profiler.kineto_results.events())
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = {}
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        ms, n = slow.get(e.key, (0.0, 0))
        slow[e.key] = (ms + getattr(e, "self_device_time_total", getattr(
            e, "self_cuda_time_total", 0.0)) / 1e3, n + e.count)
    slow_s = time.perf_counter() - t0
    worst = max(abs(fast[k][0] - slow[k][0]) / max(slow[k][0], 1e-12)
                for k in slow) if slow else 0.0
    line("profile_rows", rows=len(fast), launches=sum(
        n for _, n in fast.values()), raw_events_s=f"{fast_s:.3f}",
         key_averages_s=f"{slow_s:.3f}", max_rel_diff=worst)
    assert fast.keys() == slow.keys() and slow, (fast.keys() ^ slow.keys())
    assert all(fast[k][1] == slow[k][1] for k in slow)
    assert worst <= 1e-6, worst


def profile_call(torch, fn, unprofiled_ms=None, **tags) -> None:
    """Device time of one call of ``fn`` by kernel (``profile_device``:
    torch.profiler, CUPTI): the device's busy share of the wall time and
    the port kernels' share. The profiler slows the host's launches, so
    where the caller timed the same call without it (``unprofiled_ms``)
    the share of that time is printed too."""
    rows, wall_ms = profile_device(fn)
    per_name = {k: ms for k, (ms, _) in rows.items()}
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


def routed_out(idx, m):
    """A copy of ``idx [B, N]`` with rows routed out both ways (>= M, -1)."""
    out = idx.clone()
    out[:, :64] = m + 3
    out[:, 64:128] = -1
    return out


def grid_rows(torch, gen, *shape):
    """Rows of multiples of 1/64 in [-4, 4]: their f32 sums are exact in
    any order up to 2^16 rows a segment, so a comparison on them checks the
    routing and bucketing alone, whatever a segment's size (a sum of 900
    N(0, 1) rows in two orders already differs past rtol / atol 1e-5 about
    once in a hundred)."""
    return torch.randint(-256, 257, shape, generator=gen).float() / 64


def segment_id_maps(torch, gen, b: int, n: int, m: int):
    """The id maps the segment sums' bucketing is sensitive to, drawn as
    ``tests/test_torch_segment_sums.py`` draws them: ``{kind: (idx [b, n]
    int32 on the CPU, M)}`` with one segment taking 90% of the rows, M = 1,
    the first and last two segments empty, every row routed out by -1 and
    by >= M, and two samples drawn differently (uniform; the upper half
    with a quarter routed out)."""
    def ids(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)
    skew = ids(0, m, b, n)
    skew[torch.rand(b, n, generator=gen) < 0.9] = m // 2
    per_sample = ids(0, m, b, n)
    per_sample[1] = ids(m // 2, m, n)
    per_sample[1][torch.rand(n, generator=gen) < 0.25] = -1
    return {"skew": (skew, m), "one_segment": (ids(-1, 2, b, n), 1),
            "empty_ends": (ids(2, m - 2, b, n), m),
            "all_minus_one": (torch.full((b, n), -1, dtype=torch.int32), m),
            "all_past_m": (m + ids(0, 5, b, n), m),
            "per_sample": (per_sample, m)}


def hold_segment_case(torch, fn, plain, compared, kind, data, grid, ix,
                      m):
    """One edge case of the segment sum ``fn`` (ids ``ix [B, N]`` or ``[B,
    P, N]``): on :func:`grid_rows` within rtol / atol 1e-5 of ``plain``,
    with the samples or hypotheses whose rows are all routed out all zeros;
    on N(0, 1) rows bit-equal across two launches (counted in
    ``compared``)."""
    got = fn(grid, ix, m)
    want = plain(grid, ix, m)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    dead = ((ix < 0) | (ix >= m)).all(dim=-1)
    assert not got[dead].any(), kind
    first = fn(data, ix, m)
    assert torch.equal(fn(data, ix, m), first), kind
    compared.append(kind)
    del first
    t_ms = cuda_ms(lambda: fn(data, ix, m), 3)
    line("segment_case", kernel=fn.__name__, kind=kind,
         shape="x".join("[" + ",".join(map(str, t.shape)) + "]"
                        for t in (data, ix)) + f"->m={m}",
         dead=int(dead.sum()), max_abs_err=(got - want).abs().max().item(),
         same_bits=True, kernel_ms=f"{t_ms:.5f}")


def geo_step_segment_calls(torch, kernels, serve, kitti_config, dev):
    """Kernel 5's calls in one geo train step (KITTI width, B=8, f32, seed
    0): the gradients of the step's row gathers, with the ids the
    synthetic batch and the model give them."""
    from cmr_agent_tpu_torch.train import train_geo
    cfg = kitti_config()
    batch = serve.synthetic_batch(cfg, B, dev, seed=0, keys=serve.TRAIN_KEYS)
    step = train_geo.make_geo_train_step(cfg)
    state = train_geo.create_geo_state(cfg, dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = capture("segment_sum", lambda: step(state, batch, gen))
    del state, batch
    torch.cuda.empty_cache()
    return calls


def warp_segment_calls(torch, kernels, serve, kitti_config):
    """Kernel 7's calls in one ``IterModel`` forward of the flagship
    workload (f32): the cost volume's ``[feat | score | 1]`` rows and the
    pixel ids its warp projects under each eval chunk of hypotheses."""
    from cmr_agent_tpu_torch.train.train_iter import iter_model_state
    cfg, batch, (geo, iter_model, _), _ = flagship_workload(
        torch, serve, kitti_config, "float32")
    with torch.no_grad():
        st = iter_model_state(geo(batch), batch)
        calls = capture("segment_sum_shared",
                        lambda: iter_model(st, with_loss=False))
    del st, geo, iter_model, batch
    torch.cuda.empty_cache()
    return calls


def hold_path_calls(torch, kernels, name: str, calls, names, library=()):
    """Kernel ``name`` on the calls a path made (``segment_turns.capture``):
    each call's rows rounded to multiples of 1/64 in [-4, 4] after scaling
    by their largest magnitude (sums exact in any order) within rtol / atol
    1e-5 of the plain version, its own rows bit-equal across two launches,
    and how its ids spread over the segments (``[segment_path]``); then
    all calls in turn: wrapper time, device time of the kernels ``names``,
    the plain version's and ``library``'s (one PyTorch call per call, as
    argument-free callables) (``[segment_path_total]``)."""
    fn, plain = getattr(kernels, name), kernels.PLAIN[name]
    for i, (data, ix, m) in enumerate(calls):
        grid = torch.round(data / data.abs().amax().clamp_min(1e-30)
                           * 256) / 64
        got, want = fn(grid, ix, m), plain(grid, ix, m)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = (got - want).abs().max().item()
        del got, want, grid
        first = fn(data, ix, m)
        assert torch.equal(fn(data, ix, m), first), (name, i)
        del first
        flat = ix.reshape(-1, ix.shape[-1]).long()
        valid = (flat >= 0) & (flat < m)
        counts = torch.zeros(flat.shape[0], m + 1, dtype=torch.long,
                             device=flat.device).scatter_add_(
            1, torch.where(valid, flat, m), torch.ones_like(flat))[:, :m]
        line("segment_path", kernel=name, call=i,
             shape="x".join("[" + ",".join(map(str, t.shape)) + "]"
                            for t in (data, ix)) + f"->m={m}",
             rows_landed=int(valid.sum()), segments_filled=int(
                 (counts > 0).sum()), max_rows_per_segment=int(counts.max()),
             max_abs_err=err, same_bits=True,
             kernel_ms=f"{cuda_ms(lambda: fn(data, ix, m), 5):.5f}")
        del counts, flat, valid
        torch.cuda.empty_cache()

    def each(f):
        return lambda: [f(data, ix, m) for data, ix, m in calls]
    lib = (f"{cuda_ms(lambda: [f() for f in library], 5):.5f}" if library
           else "none")
    line("segment_path_total", kernel=name, calls=len(calls),
         kernel_ms=f"{cuda_ms(each(fn), 5):.5f}",
         device_ms=fmt_ms(kernel_device_ms(each(fn), names, iters=3)),
         plain_ms=f"{cuda_ms(each(plain), 2):.5f}", library_ms=lib)


def scatter_add_library(torch, calls):
    """Kernel 5's library call for each of ``calls``: ``scatter_add_`` of
    the rows into a zeroed ``[B, M + 1, F]`` whose last row takes the
    routed-out ones."""
    def call(data, idx, m):
        b, n, f = data.shape
        seg = torch.where((idx >= 0) & (idx < m), idx, m).long()
        seg = seg[..., None].expand(b, n, f)
        return lambda: torch.zeros(b, m + 1, f, device=data.device
                                   ).scatter_add_(1, seg, data)
    return [call(*c) for c in calls]


# the kernels of kernels 5 and 7, by name, for their device time
SEGMENT_SUM_KERNEL_NAMES = ("segment_bucket_kernel", "segment_reduce_kernel")
SEGMENT_SUM_SHARED_KERNEL_NAMES = ("segment_sum_shared_kernel",)
# (B, N, M, F) of the bucketing cases: a training shape, then F = 3 and
# F = 66 with N a multiple of no chunk
SEGMENT_CASE_SHAPES = ((2, N_PT, N_NODE, F), (2, 1000, 37, 3),
                       (2, 77, 19, F + 2))


def check_segment_sum(torch, kernels, dev, randn, randint, path_calls):
    """Kernel 5 (the row gather's backward) at the training shapes (points
    -> nodes, the knn neighbourhoods -> nodes, nodes -> proxies) with and
    without rows routed out, within rtol / atol 1e-5 of its plain version
    and bit-equal to a second launch, the gather's VJP against autograd of
    the plain gather; then :func:`segment_id_maps` at
    ``SEGMENT_CASE_SHAPES``, on :func:`grid_rows` against the plain version
    and on N(0, 1) rows launch against launch; then the geo train step's
    own calls, ``path_calls`` (:func:`geo_step_segment_calls`). Returns
    the rows of the three shapes."""
    rows, compared = {}, []
    for n, m in ((N_PT, N_NODE), (N_NODE * KNN_K, N_NODE), (N_NODE, N_PROXY)):
        data, idx = randn(B, n, F), randint(0, m, B, n)
        for ix in (idx, routed_out(idx, m)):
            got = kernels.segment_sum(data, ix, m)
            want = kernels.segment_sum_plain(data, ix, m)
            # the kernel adds each segment's rows in ascending order, the
            # plain version's scatter_add_ in the order its atomics land
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            assert torch.equal(kernels.segment_sum(data, ix, m), got), (n, m)
            compared.append((n, m))
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
            max_abs_err=err, tol="rtol 1e-5 atol 1e-5 (another order of "
                                 "f32 sums); gather VJP vs autograd "
                                 "likewise; bit-equal across launches",
            shape=f"[{B},{n},{F}]->[{B},{m},{F}]",
            ms=cuda_ms(lambda: kernels.segment_sum(data, idx, m), 20),
            device_ms=kernel_device_ms(
                lambda: kernels.segment_sum(data, idx, m),
                SEGMENT_SUM_KERNEL_NAMES),
            host_us=host_us(torch, lambda: kernels.segment_sum(data, idx, m)),
            plain_ms=cuda_ms(lambda: kernels.segment_sum_plain(data, idx, m),
                             10),
            library_ms=cuda_ms(lambda: torch.zeros(B, m, F, device=dev)
                               .scatter_add_(1, idx64, data), 20),
            bound=bound(B * (n * F * 4 + n * 4 + m * F * 4), B * n * F))
        rows[f"segment_sum[{n}->{m}]"] = r
        print_rows({f"segment_sum[{n}->{m}]": r})
    gen = torch.Generator().manual_seed(55)
    for b, n, m_, f in SEGMENT_CASE_SHAPES:
        data = torch.randn(b, n, f, generator=gen).to(dev)
        grid = grid_rows(torch, gen, b, n, f).to(dev)
        for kind, (ix, m) in segment_id_maps(torch, gen, b, n, m_).items():
            hold_segment_case(torch, kernels.segment_sum,
                              kernels.segment_sum_plain, compared, kind,
                              data, grid, ix.to(dev), m)
    line("segment_sum_bits", launches_compared=len(compared),
         bit_equal=len(compared))
    hold_path_calls(torch, kernels, "segment_sum", path_calls,
                    SEGMENT_SUM_KERNEL_NAMES,
                    scatter_add_library(torch, path_calls))
    return rows


def check_train_kernels(torch, kernels, serve, kitti_config, dev):
    """Phase 5: the training path's kernels vs their plain versions at the
    training shapes (and the backward kernels vs torch.autograd of the
    plain forward)."""
    gen, randn, randint = rand_factory(torch, 4321, dev)
    # 5. segment sum (the gather's backward)
    sum_rows = check_segment_sum(
        torch, kernels, dev, randn, randint,
        geo_step_segment_calls(torch, kernels, serve, kitti_config, dev))
    rows = {"segment_sum": sum_rows[f"segment_sum[{N_PT}->{N_NODE}]"]}

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
            library_ms=(index_add_ms(torch, data, ids, hw) if dt is None
                        else None),
            bound=bound(B * RASTER_K * 4 + landed * F * elt
                        + B * hw * (F + 1) * 4,
                        (F + 1.0) * landed + B * hw * F))
        print_rows({f"segment_mean_count_image[{mode}]": modes[mode]})
    rows["segment_mean_count_image"] = modes["f32"]
    return rows, modes


def index_add_ms(torch, data, ids, hw: int) -> float:
    """The library call of a pixel-id raster: ``index_add_`` of the rows
    with a ones column (the counts), flattened, into ``[B * (hw + 1),
    F + 1]`` (one spill row per sample for the routed-out ids)."""
    b, k, f = data.shape
    pix = torch.where((ids >= 0) & (ids < hw), ids, hw).long()
    flat = (pix + (hw + 1) * torch.arange(b, device=data.device)[:, None]
            ).reshape(-1)
    rows2d = torch.cat([data, data.new_ones(b, k, 1)], -1).reshape(b * k,
                                                                   f + 1)
    return cuda_ms(lambda: torch.zeros(
        b * (hw + 1), f + 1, device=data.device).index_add_(0, flat, rows2d),
        20)


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

    compare_geo_twins(torch, kernels, cfg, batch, dev)
    return counts, state, batch


def compare_geo_twins(torch, kernels, cfg, batch, dev) -> None:
    """Phase 6's gate: the geo train step's gradients and three steps'
    losses, a twin with the kernels against a twin with the plain versions,
    both from seed 0 with dropout off. Prints ``[geo_train_vs_plain]``."""
    from cmr_agent_tpu_torch.models.layers import set_dropout_rate
    from cmr_agent_tpu_torch.train import train_geo
    step = train_geo.make_geo_train_step(cfg)
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
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["kernels"],
                                               losses["plain"])]
    hold_gradients("geo_train_vs_plain", grads["kernels"], grads["plain"],
                   nudged,
                   loss_kernels=",".join(f"{v:.7f}" for v in
                                         losses["kernels"]),
                   loss_plain=",".join(f"{v:.7f}" for v in losses["plain"]),
                   loss_rel_diff=",".join(f"{v:.2e}" for v in rel))
    # step 1 differs only by summation order; Adam's normalised update can
    # turn a near-zero gradient element's sign into a full lr step after it
    assert rel[0] <= 1e-5 and max(rel) <= 1e-3, (losses, rel)


def hold_gradients(tag: str, got, want, nudged, **extra) -> None:
    """Phase 6's gradient rule: each tensor of ``got`` (the kernels' twin)
    within 1e-3 of ``want``'s (the plain twin's) max, or within 4x what a
    last-bit nudge of the input already moves (``nudged``: the plain twin's
    gradients on nudged inputs); at most 1% of the tensors past that, each
    within 2e-3 of its max. Prints the statistics (and ``extra``) on a
    ``[tag]`` line, then asserts the rule."""
    worst, beyond, worst_vs_floor, outliers = 0.0, 0, 0.0, []
    worst_rel, floors_rel = 0.0, []
    for n, g in got.items():
        w = want[n]
        scale = w.abs().max().item()
        diff = (g - w).abs().max().item()
        floor = max((gn[n] - w).abs().max().item() for gn in nudged)
        # The twins sum in other orders: the plain versions' scatter_add_
        # atomics and cuDNN's convolution backward change their order on
        # every run, kernels 1 and 5 add in ascending row order. Within
        # 1e-3 max|g|, or within 4x what a last-bit nudge of the input
        # moves. The run-to-run order is one more draw of that
        # noise: one run saw a single tensor of 995 at 1.37e-3 max|g|, 6.9x
        # its (then single) nudge, so at most 1% of the tensors may land
        # past the rule, within 2e-3 max|g|.
        tol = max(1e-3 * scale, 4.0 * floor) + 1e-7
        if diff > tol:
            outliers.append((n, diff, scale, floor))
            worst_rel = max(worst_rel, diff / scale)
        worst = max(worst, diff / tol)
        if scale > 0:
            floors_rel.append(floor / scale)
        if diff > 1e-3 * scale + 1e-7:
            beyond += 1
            worst_vs_floor = max(worst_vs_floor, diff / max(floor, 1e-30))
    line(tag, grad_tensors=len(got), max_diff_over_tol=f"{worst:.3f}",
         tensors_past_tol=len(outliers), tensors_beyond_1e3_of_max=beyond,
         past_tol_max_diff_over_max_abs=f"{worst_rel:.3e}",
         nudge_floor_over_max_abs_median=(
             f"{statistics.median(floors_rel):.3e}"),
         their_max_diff_over_nudge_diff=f"{worst_vs_floor:.3f}", **extra)
    for o in outliers:
        assert o[1] <= 2e-3 * o[2] + 1e-7, o
    assert len(outliers) <= len(got) // 100, outliers


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
    for mb in minibatches(torch, samples, order, pbs):
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

    agent_train_twin(torch, kernels, cfg, geo_out, batch, dev,
                     order[order < B * cfg.action_num],
                     "agent_train_vs_plain")
    return counts


def minibatches(torch, samples, order, pbs: int):
    """Full minibatches of ``pbs`` rows of ``samples`` in ``order``, as
    ``cli/train_agent.py`` takes them."""
    for s in range(0, len(order) - pbs + 1, pbs):
        rows = torch.as_tensor(order[s:s + pbs],
                               device=samples["state_2d"].device)
        yield {k: v.index_select(0, rows) for k, v in samples.items()}


def agent_train_twin(torch, kernels, cfg, geo_out, batch, dev, order,
                     tag: str) -> None:
    """Phase 7's gate: an ``expert_beta=1.0`` rollout and one update on
    the first minibatch of ``order``, each against its twin with the plain
    kernels, from the same agent weights. Prints ``[tag]``."""
    from cmr_agent_tpu_torch.env.buffer import TrajectoryBuffer
    from cmr_agent_tpu_torch.train import train_agent
    rollout = train_agent.make_rollout_fn(cfg)
    update = train_agent.make_ppo_update_step(cfg)
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
            mb = next(minibatches(torch, buf.samples(), order,
                                  cfg.ppo_batch_size))
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
    line(tag, expert_beta=1.0,
         action_shapes=f"{tuple(tk['action_r'].shape)}"
                       f"+{tuple(tk['action_t'].shape)}",
         state_2d_max_diff=(tk["state_2d"] - tp["state_2d"]).abs().max()
         .item(), **{f"{k}_max_diff": v for k, v in diffs.items()},
         update_loss_kernels=f"{mk['loss'].item():.7f}",
         update_loss_plain=f"{mp['loss'].item():.7f}")


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


def check_segment_sum_shared(torch, kernels, dev, randn, randint,
                             path_calls):
    """Kernel 7 at one eval chunk of the cost volume's warp: [feat | score
    | 1] rows of the top-K compacted cloud, a pixel id per (hypothesis,
    row); about 40% of the rows land, hypothesis 1 sees nothing, ids >= M
    and -1 both route out. Within rtol / atol 1e-5 of its plain version,
    the dead hypothesis all zeros, bit-equal to a second launch; then
    :func:`segment_id_maps` stacked as hypotheses (and M = 1) at the
    shapes of ``SEGMENT_CASE_SHAPES`` (the second and third take the
    one-element stores: M * F is no multiple of 4); then the warp's own
    calls in one ``IterModel`` forward, which ``path_calls()`` captures
    (:func:`warp_segment_calls`) once the rows above are measured. Prints
    and returns its row."""
    npix, f = IMG_H * IMG_W, F + 2
    data = randn(B, WARP_K, f)
    idx = randint(0, int(npix * 2.5), B, CHUNK_P, WARP_K)
    idx[:, 1] = npix
    idx[:, 2, :100] = -1
    got = kernels.segment_sum_shared(data, idx, npix)
    want = kernels.segment_sum_shared_plain(data, idx, npix)
    # the kernel adds each pixel's rows in ascending order, the plain
    # version's scatter_add_ in the order its atomics land
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not got[:, 1].any()
    err = (got - want).abs().max().item()
    del want
    assert torch.equal(kernels.segment_sum_shared(data, idx, npix), got)
    compared = ["phase 8"]
    landed = int(((idx >= 0) & (idx < npix)).sum().item())
    del got
    ms = cuda_ms(lambda: kernels.segment_sum_shared(data, idx, npix), 5)
    device_ms = kernel_device_ms(
        lambda: kernels.segment_sum_shared(data, idx, npix),
        SEGMENT_SUM_SHARED_KERNEL_NAMES, iters=3)
    plain_ms = cuda_ms(lambda: kernels.segment_sum_shared_plain(
        data, idx, npix), 2)
    # a bare write of the output, for scale, and the kernel with every row
    # routed out (the ids read and bucketed, the slabs written as zeros)
    write_ms = cuda_ms(lambda: torch.zeros((B, CHUNK_P, npix, f),
                                           device=dev), 5)
    dead_idx = torch.full_like(idx, npix)
    dead_ms = cuda_ms(lambda: kernels.segment_sum_shared(data, dead_idx,
                                                         npix), 5)
    del dead_idx
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
    row = dict(
        max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
        host_us=host_us(torch, lambda: kernels.segment_sum_shared(
            data, idx, npix), 10),
        library_ms=library_ms,
        tol="rtol 1e-5 atol 1e-5 (another order of f32 sums); dead "
            "hypothesis zeros; bit-equal across launches",
        shape=f"[{B},{WARP_K},{f}] x idx [{B},{CHUNK_P},{WARP_K}] -> "
              f"[{B},{CHUNK_P},{npix},{f}] ({out_bytes / 1e9:.2f} GB), "
              f"{landed} of {idx.numel()} rows land; a bare write of the "
              f"output {write_ms:.3f} ms, every row routed out "
              f"{dead_ms:.3f} ms",
        bound=bound(data.numel() * 4 + idx.numel() * 4 + out_bytes,
                    float(landed) * f))
    del data, idx
    torch.cuda.empty_cache()

    gen = torch.Generator().manual_seed(77)
    shapes = ((2, WARP_K, npix, f),) + SEGMENT_CASE_SHAPES[1:]
    for b, n, m_, f_ in shapes:
        data = torch.randn(b, n, f_, generator=gen).to(dev)
        grid = grid_rows(torch, gen, b, n, f_).to(dev)
        maps = segment_id_maps(torch, gen, b, n, m_)
        stacked = torch.stack([ix for ix, m in maps.values() if m == m_], 1)
        cases = {"hypotheses": (stacked, m_),
                 "one_segment": (maps["one_segment"][0][:, None], 1)}
        for kind, (ix, m) in cases.items():
            hold_segment_case(torch, kernels.segment_sum_shared,
                              kernels.segment_sum_shared_plain, compared,
                              kind, data, grid, ix.to(dev).contiguous(), m)
    print_rows({"segment_sum_shared": row})
    line("segment_sum_shared_bits", launches_compared=len(compared),
         bit_equal=len(compared))
    del data, grid
    torch.cuda.empty_cache()
    hold_path_calls(torch, kernels, "segment_sum_shared", path_calls(),
                    SEGMENT_SUM_SHARED_KERNEL_NAMES)
    return row


def check_compose_kernels(torch, kernels, serve, kitti_config, dev):
    """Phase 8: the shared-data segment sum and the mask-pack compaction
    vs their plain versions at the coarse-to-fine path's shapes."""
    gen, randn, randint = rand_factory(torch, 777, dev)
    # 7. one eval chunk of the cost volume's warp, then the warp's own calls
    rows = {"segment_sum_shared": check_segment_sum_shared(
        torch, kernels, dev, randn, randint,
        lambda: warp_segment_calls(torch, kernels, serve, kitti_config))}

    rows["mask_compact_pack"] = check_pack_kernel(torch, kernels, gen,
                                                  randn)
    return rows


PACK_KERNEL_NAMES = ("mask_rank_kernel", "mask_pack_kernel")


def pack_cases(torch, gen, randn):
    """Kernel 11's cases, ``(kind, mask, pcT, feat, k)``: at the episode's
    shape (phase 8's: ``mask [8, 40960]``, k = 20480) the counts below (30%
    kept), above (70%) and at k, an empty and a full mask, bf16 rows below
    and above k; at N = 4096, k = 6144 > N (f32), and bf16 rows of F = 5
    (10 bytes: 2-byte chunks) with a uint8 mask."""
    pcT, feat = randn(B, 3, N_PT), randn(B, N_PT, F)
    dev = feat.device

    def kept(frac, n=N_PT):
        return (torch.rand(B, n, generator=gen) < frac).to(dev)
    at = torch.zeros(B, N_PT, dtype=torch.bool)
    for row in at:
        row[torch.randperm(N_PT, generator=gen)[:RASTER_K]] = True
    n = 4096
    half, bf = kept(0.5, n), feat.to(torch.bfloat16)
    return [("below_k", kept(0.3), pcT, feat, RASTER_K),
            ("above_k", kept(0.7), pcT, feat, RASTER_K),
            ("at_k", at.to(dev), pcT, feat, RASTER_K),
            ("empty", torch.zeros_like(at).to(dev), pcT, feat, RASTER_K),
            ("full", torch.ones_like(at).to(dev), pcT, feat, RASTER_K),
            ("below_k_bf16", kept(0.3), pcT, bf, RASTER_K),
            ("above_k_bf16", kept(0.7), pcT, bf, RASTER_K),
            ("k_above_n", half, pcT[..., :n].contiguous(),
             feat[:, :n].contiguous(), 6144),
            ("odd_f_bf16", half.to(torch.uint8), pcT[..., :n].contiguous(),
             randn(B, n, 5).to(torch.bfloat16), 2048)]


def check_pack_kernel(torch, kernels, gen, randn):
    """Phase 8, kernel 11: the mask-pack compaction bit-equal to its plain
    version on every case of :func:`pack_cases`, through the wrapper and
    again through the launch alone (``kernels._mask_pack_into``) into
    outputs pre-filled with the byte 0xA5, which shows that the kernel
    writes every element (``[pack_case]``); timed at 70% kept (wrapper,
    device, host and plain times, bound). Returns the timed row."""
    row = None
    for kind, mask, pcT, feat, k in pack_cases(torch, gen, randn):
        count = (mask != 0).sum(dim=1)
        if kind.startswith("below"):
            assert (count < k).all(), kind
        elif kind.startswith("above") or kind == "full":
            assert (count > k).all(), kind
        elif kind == "at_k":
            assert (count == k).all(), kind
        gf, gp = kernels.mask_compact_pack(mask, pcT, feat, k)
        wf, wp = kernels.mask_compact_pack_plain(mask, pcT, feat, k)
        assert gf.dtype == feat.dtype and gf.shape == wf.shape, kind
        assert torch.equal(gf, wf) and torch.equal(gp, wp), kind
        pf, pp = torch.empty_like(wf), torch.empty_like(wp)
        pf.view(torch.uint8).fill_(0xA5)
        pp.view(torch.uint8).fill_(0xA5)
        kernels._mask_pack_into(mask, pcT, feat, pf, pp)
        assert torch.equal(pf, wf) and torch.equal(pp, wp), kind
        kept = int(count.clamp_max(k).sum().item())
        line("pack_case", kind=kind, shape=f"[{B},{mask.shape[1]}]",
             dtype=str(feat.dtype).replace("torch.", ""),
             F=feat.shape[-1], k=k, kept=kept, equal_plain=True,
             prefilled_equal_plain=True)
        if kind != "above_k":
            continue

        def fn():
            return kernels.mask_compact_pack(mask, pcT, feat, k)
        row = dict(
            max_abs_err=0.0, library_ms=None, ms=cuda_ms(fn, 20),
            device_ms=kernel_device_ms(fn, PACK_KERNEL_NAMES),
            host_us=host_us(torch, fn),
            plain_ms=cuda_ms(lambda: kernels.mask_compact_pack_plain(
                mask, pcT, feat, k), 5),
            tol="exact (rows are copied); counts below, at and above k, "
                "empty and full masks, k > N, f32, bf16 and odd-F bf16 "
                "rows; every element written (pre-filled outputs)",
            shape=f"mask [{B},{N_PT}], feat [{B},{N_PT},{F}] f32 -> "
                  f"k={RASTER_K}, {kept} rows kept",
            bound=bound(B * N_PT + kept * (F * 4 + 12)
                        + B * RASTER_K * (F * 4 + 12), 0.0))
        line("pack_timed", kernel_ms=f"{row['ms']:.5f}",
             device_ms=fmt_ms(row["device_ms"]),
             host_us=f"{row['host_us']:.1f}",
             plain_ms=f"{row['plain_ms']:.5f}",
             bound_us=f"{row['bound'][0] * 1e3:.2f}")
    print_rows({"mask_compact_pack": row})
    return row


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
    # the warp's per-pixel sums run in ascending row order in the kernel and
    # in the order of the plain version's scatter_add_ atomics; the
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
    # 160 episode steps, yaw nominations, accept / reject), and where any
    # sum on the path takes another order on another run, two runs of the
    # same kernels already differ wherever a choice was close. Reported: the
    # entries of candidate_scores (z-scores, O(1)) within the tolerance of the plain
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
         same_bits_second_run=bool(
             torch.equal(got["candidate_scores"], again["candidate_scores"])
             and torch.equal(got["pose"], again["pose"])),
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


def recorded_calls(kernels, name: str, fn):
    """Run ``fn()`` with ``kernels.<name>`` recording its arguments;
    returns the ``(args, kwargs)`` of every call there."""
    seen = []
    real = getattr(kernels, name)

    def spy(*a, **k):
        seen.append((a, k))
        return real(*a, **k)
    # the wrapper counts its launch on the module attribute it finds at run
    # time, here the spy: launches made while recording are not counted
    spy.launches = 0
    setattr(kernels, name, spy)
    try:
        fn()
    finally:
        setattr(kernels, name, real)
    return seen


def randomise_module_(torch, module, gen) -> None:
    """Weights at fan-in scale, biases and BatchNorm scale, bias and
    running statistics at random (a fresh BatchNorm folds to the
    identity), all from ``gen``."""
    with torch.no_grad():
        for name, t in module.named_parameters():
            if name.endswith("weight") and t.ndim == 2:
                t.copy_(torch.randn(t.shape, generator=gen)
                        / t.shape[1] ** 0.5)
            elif name.endswith("weight"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
        for name, t in module.named_buffers():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) * 1.5 + 0.5)
            elif name.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.3)


CHAIN_KERNEL_NAMES = ("chain_mma_kernel", "chain_f32_kernel")


def kernel_device_ms(fn, names, iters: int = 10):
    """Device time per call of the kernels whose names contain one of
    ``names`` (``torch.profiler``), over ``iters`` calls after a warm-up:
    the kernel alone, without the wrapper's own PyTorch ops. None, with a
    ``[profiler]`` line, where three profiles in a row record no such
    kernel (it happened once late in a whole run: every device row was
    missing); the wrapper's CUDA-event time is measured apart."""
    fn()
    for _ in range(3):   # the profiler now and then returns no rows
        by_name, _ = profile_device(fn, iters=iters)
        ms = sum(t for k, (t, _) in by_name.items()
                 if any(n in k for n in names))
        if ms > 0:
            return ms / iters
    line("profiler", no_device_time_for=",".join(names),
         device_rows=len(by_name))
    return None


def fmt_ms(ms) -> str:
    """A time in ms, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.5f}"


def host_us(torch, fn, iters: int = 50) -> float:
    """Host time per call of ``fn`` in µs: the time to enqueue its work, the
    device left to run behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def chain_row(torch, kernels, name, args, kw, library, label, dt, shape):
    """Kernel vs plain on one chain's arguments (f32 rtol/atol 1e-5;
    bf16 within one bf16 rounding of the output's scale, as the CPU tests
    hold the plain version to the Pallas kernel), with its times and the
    bound: ``ms`` is the wrapper's CUDA-event time (as on every row),
    ``device_ms`` the chain kernel's own device time (profiler), and
    ``[chain_times]`` adds the wrapper's host time per call and that of
    its weight packing alone (``kernels.pack_chain_weights``); ``library``
    times the port's unfused eval module."""
    kernel, plain = getattr(kernels, name), kernels.PLAIN[name]
    got, want = kernel(*args, **kw), plain(*args, **kw)
    outs = zip(got, want) if kw.get("out_max") else ((got, want),)
    err = 0.0
    for g, w in outs:
        g, w = g.float(), w.float()
        ulp = 2.0 ** -8
        if dt == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(g, w, rtol=ulp,
                                       atol=ulp * w.abs().max().item())
        err = max(err, (g - w).abs().max().item())
    x, weights = args[0], list(args[1])
    rw = args[3] if len(args) > 3 else kw.get("res_weight")
    mats = weights + ([rw] if rw is not None else [])
    b = x.shape[0]
    n = x.shape[2] if name.endswith("_cn") else x.shape[1]
    c0, c_out = weights[0].shape[0], weights[-1].shape[-1]
    # every layer's (and the projection's) products; x read once, the
    # output written once, the weights and the [B, C] bias rows read once
    ops = 2.0 * b * n * sum(w.shape[0] * w.shape[1] for w in mats)
    elt = x.element_size()
    nbytes = (b * n * (c0 + c_out) * elt + sum(w.numel() * elt for w in mats)
              + b * sum(w.shape[1] for w in mats) * 4)
    rate = F32_OPS_PER_S if dt == torch.float32 else BF16_OPS_PER_S
    row = dict(
        max_abs_err=err, shape=shape,
        tol=("rtol 1e-5 atol 1e-5" if dt == torch.float32 else
             "rtol 2^-8, atol 2^-8 max|out| (one bf16 rounding)"),
        ms=cuda_ms(lambda: kernel(*args, **kw), 20),
        device_ms=kernel_device_ms(lambda: kernel(*args, **kw),
                                   CHAIN_KERNEL_NAMES),
        plain_ms=cuda_ms(lambda: plain(*args, **kw), 10),
        library_ms=cuda_ms(library, 10), bound=bound(nbytes, ops, rate))
    print_rows({f"{name}[{label}]": row})
    wrapper_us = host_us(torch, lambda: kernel(*args, **kw))
    pack_us = host_us(torch,
                      lambda: kernels.pack_chain_weights(mats, x.dtype))
    line("chain_times", name=f"{name}[{label}]", ms=f"{row['ms']:.5f}",
         device_ms=fmt_ms(row["device_ms"]),
         wrapper_host_us=f"{wrapper_us:.1f}", pack_host_us=f"{pack_us:.1f}")
    return row


def check_chain_backward(torch, kernels, cn: bool, args, kw, label):
    """The chain's gradient on the card: ``kernels.dense_chain`` (kernel
    forward, autograd of the plain chain backward) against autograd of the
    plain chain on the same inputs and cotangents, for x, every weight and
    bias, the projection and ``pooled``. Bit-equal: the backward recomputes
    the plain version. Also checks that every output has a ``grad_fn``."""
    x, weights, biases = args[0], list(args[1]), list(args[2])
    rest = list(args[3:6]) + [None] * (6 - len(args))
    rest = [kw.get(k, v) for k, v in zip(("res_weight", "res_bias",
                                          "pooled"), rest)]
    opts = {k: v for k, v in kw.items()
            if k in ("slopes", "residual", "final_slope", "out_max")}
    plain = (kernels.fused_dense_chain_cn_plain if cn
             else kernels.fused_dense_chain_plain)
    gen = torch.Generator().manual_seed(7)
    grads, cot = [], None
    for fn in ("function", "plain"):
        leaves = [t.detach().clone().requires_grad_() if t is not None
                  else None for t in [x, *weights, *biases, *rest]]
        L = len(weights)
        call = (lambda *a, **k: kernels.dense_chain(*a, cn=cn, **k)) \
            if fn == "function" else plain
        with torch.enable_grad():
            outs = call(leaves[0], leaves[1:1 + L], leaves[1 + L:1 + 2 * L],
                        *leaves[1 + 2 * L:], **opts)
        outs = outs if opts.get("out_max") else (outs,)
        assert all(o.grad_fn is not None for o in outs), label
        if cot is None:
            cot = [torch.randn(o.shape, generator=gen).to(o.device, o.dtype)
                   for o in outs]
        torch.autograd.backward(outs, cot)
        grads.append([None if t is None else t.grad for t in leaves])
    diff = max((a - b).abs().max().item() for a, b in zip(*grads)
               if a is not None)
    line("chain_backward", name=label, tensors=sum(
        g is not None for g in grads[0]), max_abs_diff=diff,
        tol="bit-equal to autograd of the plain chain")
    assert diff == 0.0, (label, diff)


def chain_variant(entry_line: str) -> str:
    return "<cn>" if "ILb1E" in entry_line else "<nc>"


def int_template(entry_line: str) -> str:
    """``<G>`` of a kernel templated on one int (mangled ``ILiGE``)."""
    found = re.search(r"ILi(\d+)E", entry_line)
    return f"<{found.group(1)}>" if found else ""


def chunk_variant(entry_line: str) -> str:
    """``<bytes>`` of a kernel templated on its copy chunk (``uint4``,
    ``unsigned int``, ``unsigned short``); "" for the others."""
    for mangled, size in (("I5uint4E", 16), ("IjE", 4), ("ItE", 2)):
        if mangled in entry_line:
            return f"<{size}>"
    return ""


def print_ptxas(build, stem: str, names, variant=chain_variant) -> None:
    """Registers, stack, shared memory and spills of the kernels of
    ``csrc/<stem>.cu`` whose entry names contain one of ``names``, from
    the compiler's report in ``build.log``; ``variant`` names a template
    instance from its entry line."""
    log = (build.library_path().parent / "build.log").read_text()
    part = log.split(f"== {stem}.cu")[1].split("\n== ")[0]
    entry = None
    for ln in part.splitlines():
        if "Compiling entry function" in ln:
            entry = next((n for n in names if n in ln), None)
            if entry is not None:
                entry += variant(ln)
        elif entry is not None and ("spill" in ln or "registers" in ln):
            line("ptxas", kernel=entry, report=repr(ln.strip()))


def check_chain_kernels(torch, kernels, dev):
    """Phase 12: kernels 9 and 10 at the KITTI shapes of the fused eval
    stacks, f32 and bf16. Returns the summary rows (point_fuse_0 and
    state3d_3 in f32, the largest chains)."""
    from cmr_agent_tpu_torch.models.agent import _fused_virtual_concat_block
    from cmr_agent_tpu_torch.models.layers import MiniPointNet, ResDenseBlock
    from cmr_agent_tpu_torch.ops import build
    print_ptxas(build, "dense_chain", CHAIN_KERNEL_NAMES)
    gen = torch.Generator().manual_seed(99)
    rows = {}
    geo = (("raw_point_mlp", N_PT, lambda dt: MiniPointNet(3, F, dt, True)),
           ("raw_point_mlp_nodes", N_NODE,
            lambda dt: MiniPointNet(3, F, dt, True)),
           ("point_mlp_0", N_PT, lambda dt: MiniPointNet(2 * F, F, dt, True)),
           ("node_fuse_0", N_NODE,
            lambda dt: ResDenseBlock(2 * F, F, dt, True)),
           ("point_fuse_0", N_PT, lambda dt: ResDenseBlock(2 * F, F, dt, True)),
           ("point_fuse_1", N_PT, lambda dt: ResDenseBlock(F, F, dt, True)))
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        for label, n, make in geo:
            module = make(dt)
            randomise_module_(torch, module, gen)
            module.to(dev).eval()
            cin = module.layer_1[0].in_features if hasattr(
                module, "layer_1") else module.net[0].in_features
            scale = 20.0 if cin == 3 else 1.0
            x = (torch.randn(B, n, cin, generator=gen) * scale).to(dev, dt)
            with torch.no_grad():
                (args, kw), = recorded_calls(kernels, "fused_dense_chain",
                                             lambda: module(x))

                def library(module=module, x=x):
                    module.fused = False
                    try:
                        module(x)
                    finally:
                        module.fused = True
                row = chain_row(torch, kernels, "fused_dense_chain", args,
                                kw, library, f"{label},{tag}", dt,
                                f"{label} [{B},{n},{cin}] {tag}")
            if label == "point_fuse_0":
                check_chain_backward(torch, kernels, False, args, kw,
                                     f"fused_dense_chain[{label},{tag}]")
            if (label, tag) == ("point_fuse_0", "f32"):
                rows["fused_dense_chain"] = row
        # the agent's four 3-D stages, channel-major
        blocks = [ResDenseBlock(5, F, dt, True), ResDenseBlock(2 * F, F, dt, True),
                  ResDenseBlock(2 * F, F, dt, True),
                  ResDenseBlock(2 * F, 2 * F, dt, True)]
        for blk in blocks:
            randomise_module_(torch, blk, gen)
            blk.to(dev).eval()
        obs = torch.randn(B, 5, N_PT, generator=gen)
        obs[:, :3] *= 20.0
        obs[:, 3:] = (obs[:, 3:] > 0).float()
        obs = obs.to(dev, dt)
        feat = torch.randn(B, F, N_PT, generator=gen).to(dev, dt)
        pooled = feat.amax(dim=2)
        for i, blk in enumerate(blocks):
            with torch.no_grad():
                if i == 0:
                    (args, kw), = recorded_calls(
                        kernels, "fused_dense_chain_cn",
                        lambda: blk(obs, cn=True))
                    nc_in = obs.transpose(1, 2).contiguous()
                else:
                    (args, kw), = recorded_calls(
                        kernels, "fused_dense_chain_cn",
                        lambda: _fused_virtual_concat_block(blk, feat,
                                                            pooled, True))
                    f_nc = feat.transpose(1, 2)
                    nc_in = torch.cat([f_nc, pooled[:, None, :].expand_as(
                        f_nc)], dim=-1).contiguous()

                def library(blk=blk, nc_in=nc_in):
                    blk.fused = False
                    try:
                        blk(nc_in)
                    finally:
                        blk.fused = True
                label = f"state3d_{i},{tag}"
                if i == 3 and dt == torch.float32:
                    kw = dict(kw, out_max=True)
                    label += ",out_max"
                row = chain_row(torch, kernels, "fused_dense_chain_cn",
                                args, kw, library, label, dt,
                                f"state3d_{i} [{B},{args[0].shape[1]},"
                                f"{N_PT}] {tag}")
                if i == 3:
                    # identity_split with out_max: gradients for both
                    # outputs and pooled
                    check_chain_backward(
                        torch, kernels, True, args, dict(kw, out_max=True),
                        f"fused_dense_chain_cn[state3d_3,{tag},out_max]")
            if (i, tag) == (3, "f32"):
                rows["fused_dense_chain_cn"] = row
        del blocks, obs, feat
        torch.cuda.empty_cache()
    return rows


def run_fused_path(torch, kernels, serve, kitti_config, dtype: str):
    """Phase 13 for one compute dtype: the workload under ``fused_stacks``
    "off", "all" and "agent", built from one seed (the same weights).
    Launch counts of one episode each, then 5 rounds of one timed episode
    of each in turn (host noise falls on all three alike), a profile of
    each (device time does not depend on the host), and each fused
    episode against its plain-kernel twin and its geo outputs against the
    unfused model's. Returns the launch counts of the "all" episode."""
    runs = {}
    for fused in ("off", "all", "agent"):
        cfg = kitti_config(compute_dtype=dtype, fused_stacks=fused)
        batch, model, agent, episode = serve.build_workload(cfg, B, seed=0)
        episode(batch)                                        # warm-up
        kernels.reset_launch_counts()
        final, _ = timed(torch, lambda: episode(batch))
        counts = kernels.launch_counts()
        line("fused_launches", dtype=dtype, fused_stacks=fused, **counts)
        # 4 MiniPointNets (raw points, raw nodes, two point MLPs), the node
        # fusion blocks and both heads' point fusion blocks: 12 at KITTI
        geo_chains = 4 + cfg.node_fuse_res_num + 2 * cfg.pt_head_res_num
        assert counts["fused_dense_chain"] == (
            geo_chains if fused == "all" else 0), counts
        assert counts["fused_dense_chain_cn"] == (
            0 if fused == "off" else 4 * cfg.action_num), counts
        assert all(counts[k] > 0 for k in SERVING_KERNELS), counts
        assert torch.isfinite(final).all()
        runs[fused] = dict(cfg=cfg, batch=batch, model=model, agent=agent,
                           episode=episode, counts=counts, times=[])
    for _ in range(5):
        for r in runs.values():
            r["times"].append(timed(torch, lambda: r["episode"](r["batch"]))[1])
    with torch.inference_mode():
        geo_off = runs["off"]["model"](runs["off"]["batch"])
    atol, rtol = (1e-3, 0.0) if dtype == "float32" else (1e-2, 3e-2)
    for fused, r in runs.items():
        median = statistics.median(r["times"])
        line("fused_throughput", dtype=dtype, fused_stacks=fused,
             pairs_per_s=f"{B / median:.3f}",
             episode_s=",".join(f"{t:.4f}" for t in r["times"]))
        profile_call(torch, lambda: r["episode"](r["batch"]),
                     unprofiled_ms=median * 1e3, phase="fused", dtype=dtype,
                     fused_stacks=fused)
        if fused == "off":
            continue
        cfg, model, agent, batch = r["cfg"], r["model"], r["agent"], r["batch"]
        got = serve.serve_episode(model, agent, cfg, batch)
        with plain_kernels(kernels):
            want = serve.serve_episode(model, agent, cfg, batch)
        steps, diff = compare_episodes(torch, got, want, atol, rtol)
        with torch.inference_mode():
            geo = model(batch)
        geo_diff = {k: (geo[k].float() - geo_off[k].float()).abs().max()
                    .item() for k in ("pc_geo_feat", "img_geo_feat",
                                      "pc_overlap_logits")}
        line("fused_vs_plain", dtype=dtype, fused_stacks=fused,
             logit_atol=atol, logit_rtol=rtol, steps_compared=steps,
             max_logit_diff=diff,
             final_pose_max_diff=(got["final_pose"] - want["final_pose"]
                                  ).abs().max().item(),
             **{f"geo_vs_unfused_{k}": v for k, v in geo_diff.items()})
        if dtype == "float32":
            # BN folding changes only the rounding: 1e-4 on the geo outputs
            assert all(v <= 1e-4 for v in geo_diff.values()), geo_diff
    counts = runs["all"]["counts"]
    del runs, geo_off
    torch.cuda.empty_cache()
    return counts


def compact_modes(torch, kernels, data, ids, label: str, modes=None,
                  timed: bool = False):
    """Kernel 8 against its plain version on one input in each of
    ``modes`` (default all three, else the names of :data:`RASTER_MODES`
    to run): counts exact, int8 sums bit-equal, f32 / bf16 sums within
    rtol 1e-5 atol 1e-5 (f32 sums in another order), every mode the same
    bits on a second launch. With ``timed`` each mode's wrapper, device,
    host and plain times, its bound (the same bytes as kernel 6a's) and, in
    f32, ``index_add_`` with a ones column as the library call. Returns
    ``{mode: row}``; one ``[compact_mode]`` line a mode."""
    hw = IMG_H * IMG_W
    out = {}
    for mode, dt in RASTER_MODES:
        if modes is not None and mode not in modes:
            continue
        cdt = None if dt is None else getattr(torch, dt)
        args = (data, ids, IMG_H, IMG_W, cdt)
        gs, gc = kernels.segment_sum_count_image_compact(*args)
        ws, wc = kernels.segment_sum_count_image_compact_plain(*args)
        assert torch.equal(gc, wc), (label, mode)
        err = (gs - ws).abs().max().item() if gs.numel() else 0.0
        if mode == "int8":
            assert torch.equal(gs, ws), (label, mode, err)
        else:
            torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-5)
        gs2, gc2 = kernels.segment_sum_count_image_compact(*args)
        assert torch.equal(gs2, gs) and torch.equal(gc2, gc), (label, mode)
        r = dict(max_abs_err=err, landed=int(wc.sum()), library_ms=None)
        del gs, gc, ws, wc, gs2, gc2

        def fn():
            return kernels.segment_sum_count_image_compact(*args)
        if timed:
            r.update(ms=cuda_ms(fn, 20),
                     device_ms=kernel_device_ms(fn, RASTER_KERNEL_NAMES),
                     host_us=host_us(torch, fn),
                     plain_ms=cuda_ms(lambda: kernels.
                                      segment_sum_count_image_compact_plain(
                                          *args), 5),
                     bound=image_bound(data, ids, r["landed"], hw, mode))
            if mode == "f32":
                r["library_ms"] = index_add_ms(torch, data.float(), ids, hw)
        line("compact_mode", case=label, mode=mode, shape=repr(
            list(data.shape)), data_dtype=str(data.dtype).replace(
            "torch.", ""), landed=r["landed"], max_abs_err=err,
             same_bits=True,
             **({} if not timed else dict(
                 kernel_ms=f"{r['ms']:.5f}",
                 device_ms=fmt_ms(r["device_ms"]),
                 host_us=f"{r['host_us']:.1f}",
                 plain_ms=f"{r['plain_ms']:.5f}",
                 library_ms=("none" if r["library_ms"] is None
                             else f"{r['library_ms']:.5f}"),
                 bound_us=f"{r['bound'][0] * 1e3:.2f}({r['bound'][1]})")))
        out[mode] = r
    return out


def compact_cases(torch, data, ids):
    """Kernel 8's edge cases on an episode call's ``data [B,N,F]`` f32 and
    ``ids``: ``(kind, data, ids, timed)``: the call itself (timed);
    every row routed out (timed: what the bands' scan of all N ids costs);
    every row on one pixel (rows on a 1/64 grid, exact sums in any order);
    the ids in descending order; N = 40627, a multiple of neither 512 nor
    the band kernel's 4096-id step; B = 1."""
    gen = torch.Generator().manual_seed(1414)
    hw = IMG_H * IMG_W
    routed = torch.where(torch.arange(ids.shape[1], device=ids.device) % 2
                         == 0, -1, hw).to(torch.int32).expand_as(ids)
    one = torch.full_like(ids, hw // 2 + 17)
    grid = grid_rows(torch, gen, *data.shape).to(data.device)
    n = 40627 if data.shape[1] > 40627 else data.shape[1] - 333
    return [("episode_busiest", data, ids, True),
            ("all_routed_out", data, routed.contiguous(), True),
            ("one_pixel", grid, one, False),
            ("reverse_order", data,
             ids.sort(dim=1, descending=True).values.contiguous(), False),
            (f"n_{n}", data[:, :n].contiguous(), ids[:, :n].contiguous(),
             False),
            ("batch_1", data[:1].contiguous(), ids[:1].contiguous(), False)]


def check_compact_kernels(torch, kernels, data, ids, landed: int):
    """Phase 14, kernels: the compacting raster (kernel 8, the band kernel
    writing sums) in f32, bf16 and int8 on the f32 "compact" episode's
    busiest call (``data [B,N,F]`` f32, as the geo model hands it over) and
    on :func:`compact_cases`, each mode against its plain version and
    bit-equal across launches (:func:`compact_modes`); its gradient; then
    the int8 pixel-id raster on the same call. The times are the
    wrappers' (in int8 the absmax prepass and the band kernel, both on the
    card) beside the kernels' device time. Returns the summary rows."""
    b, n, f = data.shape
    hw = IMG_H * IMG_W
    rows = {}
    for kind, d, ix, timed in compact_cases(torch, data, ids):
        modes = compact_modes(torch, kernels, d, ix, kind, timed=timed)
        got = {r["landed"] for r in modes.values()}
        want = {"episode_busiest": landed, "all_routed_out": 0,
                "one_pixel": d.shape[0] * d.shape[1]}.get(kind)
        assert want is None or got == {want}, (kind, got)
        if kind == "episode_busiest":
            rows = modes
            for mode, r in modes.items():
                r.update(tol="counts exact; int8 sums bit-equal; f32, bf16 "
                             "sums rtol 1e-5 atol 1e-5 (f32 sums in another "
                             "order); same bits on a second launch",
                         shape=f"[{b},{n},{f}] {mode} -> {IMG_H}x{IMG_W}, "
                               f"{landed} of {b * n} rows land")
                print_rows({f"segment_sum_count_image_compact[{mode}]": r})
        elif kind == "all_routed_out":
            line("compact_id_scan", rows=b * n, landed=0,
                 **{f"device_ms_{m}": fmt_ms(r["device_ms"])
                    for m, r in modes.items()})
    check_compact_backward(torch, kernels, data, ids)
    gm, gc = kernels.segment_mean_count_image(data, ids, IMG_H, IMG_W,
                                              torch.int8)
    wm, wc = kernels.segment_mean_count_image_plain(data, ids, IMG_H, IMG_W,
                                                    torch.int8)
    assert torch.equal(gc, wc) and int(gc.sum().item()) == landed
    torch.testing.assert_close(gm, wm, rtol=1e-5, atol=1e-6)
    # the "compact" raster's mean is the "flat" raster's in int8 too
    assert torch.equal(rows_sums_mean(torch, kernels, data, ids), gm)
    int8_row = dict(
        max_abs_err=(gm - wm).abs().max().item(),
        tol="counts exact; means rtol 1e-5 atol 1e-6; equal to the compact "
            "int8 raster's mean", library_ms=None,
        shape=f"[{b},{n},{f}] int8 -> {IMG_H}x{IMG_W}, {landed} rows land",
        ms=cuda_ms(lambda: kernels.segment_mean_count_image(
            data, ids, IMG_H, IMG_W, torch.int8), 20),
        plain_ms=cuda_ms(lambda: kernels.segment_mean_count_image_plain(
            data, ids, IMG_H, IMG_W, torch.int8), 10),
        bound=bound(b * n * 4 + b * n * f * 4 + b * hw * (f + 1) * 4,
                    (f + 1.0) * landed))
    print_rows({"segment_mean_count_image_int8": int8_row})
    return {"segment_sum_count_image_compact": rows["f32"],
            "segment_mean_count_image_int8": int8_row}


def hold_compact_path(torch, kernels, label: str, calls) -> None:
    """Kernel 8 on the calls of one "compact" episode: each call in its
    own compute dtype against its plain version and bit-equal across
    launches (:func:`compact_modes`, ``[compact_mode]``), then all calls in
    turn (``[compact_path_total]``: wrapper, device, host and plain
    times)."""
    fn, plain = (kernels.segment_sum_count_image_compact,
                 kernels.PLAIN["segment_sum_count_image_compact"])
    names = {v: k for k, v in RASTER_MODES}
    for i, (args, kw) in enumerate(calls):
        data, ids = args[:2]
        cdt = args[4] if len(args) > 4 else kw.get("compute_dtype")
        mode = names[None if cdt in (None, torch.float32) else
                     str(cdt).replace("torch.", "")]
        compact_modes(torch, kernels, data, ids, f"{label}_{i}", (mode,))

    def each(f):
        return lambda: [f(*args, **kw) for args, kw in calls]
    line("compact_path_total", path=label, calls=len(calls),
         kernel_ms=f"{cuda_ms(each(fn), 5):.5f}",
         device_ms=fmt_ms(kernel_device_ms(each(fn), RASTER_KERNEL_NAMES,
                                           iters=3)),
         host_us=f"{host_us(torch, each(fn), iters=10):.1f}",
         plain_ms=f"{cuda_ms(each(plain), 2):.5f}")


def check_compact_calls(torch, kernels, calls_by_dtype) -> dict:
    """Phase 14's kernel 8 on the calls of the f32 and the bf16 + int8
    "compact" episodes (``{dtype: calls}``, recorded): the gates and times
    of :func:`check_compact_kernels` on the f32 episode's busiest call,
    then :func:`hold_compact_path` on each episode's calls. Returns the
    summary rows."""
    hw = IMG_H * IMG_W
    calls = calls_by_dtype["float32"]
    landed = [int(((a[1] >= 0) & (a[1] < hw)).sum().item()) for a, _ in calls]
    line("raster_compact_steps", rows_landed_per_step=landed)
    (args, _) = calls[landed.index(max(landed))]
    rows = check_compact_kernels(torch, kernels, args[0].float().contiguous(),
                                 args[1], max(landed))
    for dtype, dtype_calls in calls_by_dtype.items():
        hold_compact_path(torch, kernels, f"compact_{dtype}", dtype_calls)
    return rows


def check_compact_backward(torch, kernels, data, ids) -> None:
    """Kernel 8's gradient on the card: ``SegmentSumCountImageCompactFn``
    (the compacting kernel forward, the row-gather kernel backward) against
    autograd of the plain version in f32, bit-equal (both gather the sums'
    gradient; routed-out rows get 0); in bf16 and int8 equal to the f32
    gradient, the rounding and the quantisation differentiated as the
    identity (the JAX package's rule for every compute dtype)."""
    g = torch.randn(data.shape[0], IMG_H * IMG_W, data.shape[-1],
                    generator=torch.Generator().manual_seed(5)).to(data.device)
    ids = ids.clone()   # the episode's ids are inference tensors
    grads = {}
    for mode, dt in (("f32", None), ("bf16", torch.bfloat16),
                     ("int8", torch.int8)):
        d = data.detach().clone().requires_grad_()
        before = kernels.gather_rows.launches
        sums, cnt = kernels.SegmentSumCountImageCompactFn.apply(
            d, ids, IMG_H, IMG_W, dt)
        assert sums.grad_fn is not None and not cnt.requires_grad
        sums.backward(g)
        assert kernels.gather_rows.launches == before + 1, mode
        grads[mode] = d.grad
    d_p = data.detach().clone().requires_grad_()
    kernels.segment_sum_count_image_compact_plain(
        d_p, ids, IMG_H, IMG_W)[0].backward(g)
    diffs = {m: (v - d_p.grad).abs().max().item() for m, v in grads.items()}
    line("compact_backward", tol="bit-equal to autograd of the plain "
         "version (f32) and to the f32 gradient (bf16, int8)",
         **{f"max_abs_diff_{m}": v for m, v in diffs.items()})
    assert all(v == 0.0 for v in diffs.values()), diffs


def rows_sums_mean(torch, kernels, data, ids):
    sums, cnt = kernels.segment_sum_count_image_compact(data, ids, IMG_H,
                                                        IMG_W, torch.int8)
    return sums / cnt.clamp_min(1.0)[..., None]


def run_raster_episodes(torch, kernels, serve, kitti_config):
    """Phase 14: one eval episode each under "compact" (f32, then bf16 +
    int8), "flat" and "topk" (bf16 + int8), the overlap head of the fresh
    weights centred on the batch's median point
    (``serve.centre_overlap_head_``: a fresh head may predict no overlap at
    all, and then no row reaches the raster). The two "compact" episodes'
    warm-ups record kernel 8's calls, which :func:`check_compact_calls`
    holds after the episodes. Each episode runs on its geo state
    (``serve.perceive``) with the kernels and with their plain versions, so
    that both twins see the same overlap flags. Returns (summary rows, the
    f32 "compact" episode's launches, the bf16 "flat" episode's
    launches)."""
    counts_by, compact_calls = {}, {}
    for mode, dtype in (("compact", "float32"), ("compact", "bfloat16"),
                        ("flat", "bfloat16"), ("topk", "bfloat16")):
        cfg = kitti_config(raster_mode=mode, compute_dtype=dtype)
        batch, model, agent, episode = serve.build_workload(cfg, B, seed=0)
        serve.centre_overlap_head_(model, batch)
        if mode == "compact":                                 # warm-up
            compact_calls[dtype] = recorded_calls(
                kernels, "segment_sum_count_image_compact",
                lambda: episode(batch))
        else:
            episode(batch)                                    # warm-up
        kernels.reset_launch_counts()
        final, seconds = timed(torch, lambda: episode(batch))
        counts = kernels.launch_counts()
        counts_by[(mode, dtype)] = counts
        line("raster_episode_launches", raster_mode=mode, dtype=dtype,
             raster_topk=cfg.episode_raster_topk(),
             episode_ms=f"{seconds * 1e3:.2f}", **counts)
        n = cfg.action_num
        if mode == "compact":
            assert counts["segment_sum_count_image_compact"] == n, counts
            assert counts["segment_mean_count_image"] == 0, counts
        else:
            assert counts["segment_mean_count_image"] == n, counts
            assert counts["segment_sum_count_image_compact"] == 0, counts
        assert counts["segment_mean_count_image_project"] == 0, counts
        assert counts["mask_compact_pack"] == 0, counts
        assert final.shape == (B, 4, 4) and torch.isfinite(final).all()
        atol, rtol = (1e-3, 0.0) if dtype == "float32" else (1e-2, 3e-2)
        with torch.inference_mode():
            state = serve.perceive(model, batch)
            got = serve.refine_episode(cfg, agent, state)
            with plain_kernels(kernels):
                want = serve.refine_episode(cfg, agent, state)
        steps, diff = compare_episodes(
            torch, {"steps": got[1], "final_pose": got[0]},
            {"steps": want[1], "final_pose": want[0]}, atol, rtol)
        line("raster_episode_vs_plain", raster_mode=mode, dtype=dtype,
             overlap_points=int(state["pc_overlap_pred"].sum().item()),
             logit_atol=atol, logit_rtol=rtol, steps_compared=steps,
             max_logit_diff=diff,
             final_pose_max_diff=(got[0] - want[0]).abs().max().item())
        del model, agent, episode, state
        torch.cuda.empty_cache()
    rows = check_compact_calls(torch, kernels, compact_calls)
    del compact_calls
    torch.cuda.empty_cache()
    return (rows, counts_by[("compact", "float32")],
            counts_by[("flat", "bfloat16")])


def check_factored_kernel(torch, kernels, dev):
    """Phase 15, kernel: the factored raster (6b: the pixel-id band kernel
    writing sums) in f32 and bf16, on tools/raster_probe.py's rows (every
    row in the frame) and on a training episode's ids (valid-first, a third
    of the prefix outside the frame, a tail routed out by ``h*w``, above it
    and by -1), with the count column appended (F + 1, the summary row,
    comparable with the earlier kernel's) and without it (F), against its
    plain version, the same bits on a second launch; its backward (the row
    gather) against autograd of the plain version. Then the factored mean
    (``segment_mean_count_image(factored=True)``: the same band kernel
    writing means) bit-equal to the flat mean on the same rows and ids and
    against the plain ones-column form (counts exact, means rtol 1e-5 atol
    1e-5), its gradient against autograd of that form. Returns
    the summary row (f32, raster_probe's rows, F + 1)."""
    from cmr_agent_tpu_torch.tools import raster_probe
    gen, randn, _ = rand_factory(torch, 5150, dev)
    hw = IMG_H * IMG_W
    feat, probe_ids = raster_probe.make_inputs(B, RASTER_K, F, IMG_H, IMG_W,
                                               1.0, False, dev)
    ones = torch.ones(B, RASTER_K, 1, device=dev)
    aug = torch.cat([feat, ones], -1).contiguous()
    counts = torch.randint(RASTER_K // 4, RASTER_K - 64, (B, 1),
                           generator=gen)
    row = torch.arange(RASTER_K)[None, :]
    lands = (row < counts) & (torch.rand(B, RASTER_K, generator=gen) > 1 / 3)
    train_ids = torch.where(lands, torch.randint(0, hw, (B, RASTER_K),
                                                 generator=gen),
                            torch.full((B, RASTER_K), hw))
    train_ids[:, -64:-32] = hw + 5
    train_ids[:, -32:] = -1
    train_ids = train_ids.to(torch.int32).to(dev)
    g = randn(B, hw, F + 1)
    rows = {}
    for layout, ids in (("probe", probe_ids), ("train", train_ids)):
        landed = int(((ids >= 0) & (ids < hw)).sum().item())
        for width, rows_in in (("", aug), (f",F{F}", feat)):
            f = rows_in.shape[-1]
            g_f = g[..., :f].contiguous()
            for mode, dt in (("f32", None), ("bf16", torch.bfloat16)):
                data = rows_in if dt is None else rows_in.to(dt)
                args = (data, ids, IMG_H, IMG_W, dt)
                got = kernels.segment_sum_image(*args)
                same_bits = torch.equal(kernels.segment_sum_image(*args),
                                        got)
                assert same_bits, (layout, width, mode)
                want = kernels.segment_sum_image_plain(*args)
                if f == F + 1:
                    assert torch.equal(got[..., -1], want[..., -1]), (
                        layout, mode)
                    assert int(got[..., -1].sum().item()) == landed, (
                        layout, mode)
                # the plain version's scatter_add_ atomics add in an order
                # that changes between runs; the kernel's order is fixed
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
                d = data.detach().clone().requires_grad_()
                d_p = data.detach().clone().requires_grad_()
                kernels.SegmentSumImageFn.apply(d, ids, IMG_H, IMG_W,
                                                dt).backward(g_f)
                kernels.segment_sum_image_plain(d_p, ids, IMG_H, IMG_W,
                                                dt).backward(g_f)
                assert torch.equal(d.grad, d_p.grad), (layout, width, mode)
                library_ms = (index_add_ms(torch, feat, ids, hw)
                              if dt is None and f == F + 1 else None)
                elt = data.element_size()

                def fn():
                    return kernels.segment_sum_image(*args)
                r = dict(
                    max_abs_err=(got - want).abs().max().item(),
                    same_bits=same_bits,
                    tol="counts exact; sums rtol 1e-5 atol 1e-5 (the plain "
                        "version's scatter_add_ atomics reorder its sums); "
                        "VJP vs autograd exact",
                    shape=f"[{B},{RASTER_K},{f}] {mode} -> {IMG_H}x{IMG_W}, "
                          f"{landed} rows land",
                    ms=cuda_ms(fn, 50),
                    device_ms=kernel_device_ms(fn, RASTER_KERNEL_NAMES),
                    host_us=host_us(torch, fn),
                    plain_ms=cuda_ms(lambda: kernels.segment_sum_image_plain(
                        *args), 10),
                    library_ms=library_ms,
                    bound=bound(B * RASTER_K * 4 + landed * f * elt
                                + B * hw * f * 4, f * 1.0 * landed))
                del got, want, d, d_p
                print_rows({f"segment_sum_image_factored[{layout},{mode}"
                            f"{width}]": r})
                rows.setdefault("segment_sum_image_factored", r)
        for mode, dt in (("f32", None), ("bf16", torch.bfloat16)):
            # bf16 rows, as above: the plain version's autograd rounds the
            # gradient where it casts f32 rows to bf16
            data = feat if dt is None else feat.to(dt)
            args = (data, ids, IMG_H, IMG_W, dt)

            def fact():
                return kernels.segment_mean_count_image(*args, factored=True)

            def flat():
                return kernels.segment_mean_count_image(*args)
            (fact_m, fact_c), (flat_m, flat_c) = fact(), flat()
            equal_flat = (torch.equal(fact_m, flat_m)
                          and torch.equal(fact_c, flat_c))
            assert equal_flat, (layout, mode)
            plain_m, plain_c = kernels.segment_mean_count_image_plain(
                *args, factored=True)
            assert torch.equal(fact_c, plain_c), (layout, mode)
            # the plain ones-column sums' scatter_add_ atomics reorder them
            torch.testing.assert_close(fact_m, plain_m, rtol=1e-5, atol=1e-5)
            mean_err = (fact_m - plain_m).abs().max().item()
            d = data.detach().clone().requires_grad_()
            d_p = data.detach().clone().requires_grad_()
            g_f = g[..., :F].contiguous()
            kernels.segment_mean_count_image(d, *args[1:], factored=True)[
                0].backward(g_f)
            kernels.segment_mean_count_image_plain(d_p, *args[1:],
                                                   factored=True)[
                0].backward(g_f)
            assert torch.equal(d.grad, d_p.grad), (layout, mode)
            line("factored_mean", layout=layout, mode=mode,
                 landed=int(fact_c.sum().item()), equal_flat=equal_flat,
                 max_abs_err_vs_plain=mean_err, vjp_exact=True, fact_ms=f"{cuda_ms(fact, 50):.5f}",
                 flat_ms=f"{cuda_ms(flat, 50):.5f}")
            del fact_m, fact_c, flat_m, flat_c, plain_m, plain_c, d, d_p
    return rows["segment_sum_image_factored"]


# 3 raster probes x 2 "fact" cases (f32, bf16) x (3 warm-up + 50 timed) calls
PROBE_FACTORED_LAUNCHES = 3 * 2 * (3 + 50)


def run_raster_probes(torch, kernels, run):
    """``raster_probe`` with every row in the frame, with a quarter
    valid-first and with a quarter scattered, each through ``run``.
    Returns the factored kernel's launches over the three, which must be
    :data:`PROBE_FACTORED_LAUNCHES`."""
    from cmr_agent_tpu_torch.tools import raster_probe
    kernels.reset_launch_counts()
    for argv in ([], ["--valid-frac", "0.25"],
                 ["--valid-frac", "0.25", "--scattered"]):
        out = run("raster_probe", raster_probe.main, argv)
        assert all(v > 0 for k, v in out.items() if k.endswith("_ms")), out
    launches = kernels.segment_sum_image.launches
    assert launches == PROBE_FACTORED_LAUNCHES, launches
    return launches


def run_tool(tag, main, argv):
    """A tool's ``main`` with its stdout captured; its JSON on a line."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        out = main(argv)
    print(f"[{tag}] {json.dumps(out)}", flush=True)
    return out


def run_tools(torch, kernels):
    """Phase 15, tools: :func:`run_raster_probes`, then ``episode_trace``
    (bf16, 3 episodes) and ``train_probe`` (10 steps per variant), each
    through its ``main`` with its JSON on a line of its own. Returns the
    factored kernel's launches over the three probes."""
    from cmr_agent_tpu_torch.tools import episode_trace, train_probe
    launches = run_raster_probes(torch, kernels, run_tool)
    out = run_tool("episode_trace", episode_trace.main,
                   ["--dtype", "bfloat16", "--iters", "3", "--top", "12"])
    assert out["total_device_ms_per_iter"] > 0 and out["top"], out
    out = run_tool("train_probe", train_probe.main, ["--steps", "10"])
    assert all(v > 0 for v in out["ms_per_step"].values()), out
    return launches


def raster_variant(entry_line: str) -> str:
    """``<type,ints...>`` of a template instance on an operand type and
    integers or flags (kernels 1, 4 and 6a)."""
    kind = "bf16" if "__nv_bfloat16" in entry_line else "f32"
    return "<" + ",".join([kind] + re.findall(r"L[ib](\d+)E", entry_line)) + ">"


def knn_cases(torch, gen, dev, geo_calls):
    """Kernel 3's cases: ``(kind, xyz, query, k)``: the serving shape; k 1,
    8, 16 and 32 at N = 1000 and 4096 with 777 queries drawn apart; a cloud
    of exact duplicates (1000 points on 343 grid sites, every distance
    exact, ties to the lower index); the geo forward's own calls."""
    def cloud(b, n, scale):
        return (torch.randn(b, n, 3, generator=gen) * scale).to(dev)
    serving = cloud(B, N_NODE, 20.0)
    cases = [("serving", serving, serving, KNN_K)]
    for n in (1000, 4096):
        xyz, query = cloud(2, n, 5.0), cloud(2, 777, 5.0)
        cases += [(f"n{n}_m777_k{k}", xyz, query, k) for k in (1, 8, 16, 32)]
    dup = (torch.randint(-3, 4, (2, 1000, 3), generator=gen).float() / 2
           ).to(dev)
    cases.append(("duplicates", dup, dup, 32))
    cases += [(f"geo_forward_{i}", *args[:3])
              for i, (args, _) in enumerate(geo_calls)]
    return cases


def raster_cases(torch, gen, dev):
    """Kernel 4's edge cases: ``(kind, pcT, feat, ab, counts, h, w)``."""
    base = raster_cloud(B, RASTER_K, F, IMG_H, IMG_W, dev, gen)
    pcT, feat, ab, counts = base
    ends = counts.clone()
    ends[0], ends[1] = 0, RASTER_K
    # an identity camera: the pixel of (x, y, z) is (x / z, y / z)
    eye = torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0]).repeat(B, 1
                                                                      ).to(dev)
    full = torch.full((B,), RASTER_K, dtype=torch.int32, device=dev)
    one = torch.ones(B, 3, RASTER_K, device=dev)
    one[:, 0], one[:, 1] = IMG_W // 2, IMG_H // 2
    grid = grid_rows(torch, gen, B, RASTER_K, F).to(dev)
    behind = pcT.clone()
    behind[:, 2] = -behind[:, 2].abs()
    # four rows on every pixel (jittered by up to 0.3): each band boundary,
    # which falls inside an image row, sees rows on both of its sides
    px = torch.arange(IMG_H * IMG_W).repeat(4)
    jit = (torch.rand(2, B, RASTER_K, generator=gen) - 0.5) * 0.6
    every = torch.stack([
        ((px % IMG_W).float() + jit[0]).clamp(0, IMG_W - 1),
        ((px // IMG_W).float() + jit[1]).clamp(0, IMG_H - 1),
        torch.ones(B, RASTER_K)], 1).contiguous().to(dev)
    zero = feat.clone()
    zero[..., 3] = 0.0
    odd_h, odd_w = 37, 101
    return [("phase3", *base, IMG_H, IMG_W),
            ("counts_0_and_K", pcT, feat, ab, ends, IMG_H, IMG_W),
            ("one_pixel", one, grid, eye, full, IMG_H, IMG_W),
            ("behind_camera", behind, feat, ab, full, IMG_H, IMG_W),
            ("every_pixel", every, feat, eye, full, IMG_H, IMG_W),
            ("odd_frame_37x101", pcT, feat, ab, counts, odd_h, odd_w),
            ("zero_channel", pcT, zero, ab, counts, IMG_H, IMG_W)]


def episode_path_calls(torch, serve, kitti_config):
    """Kernels 3 and 4's calls in one bf16 + int8 serving episode (KITTI
    width, B=8, seed 0, the fresh overlap head centred on the median point
    so that about half the top-K rows are valid), captured: ``(knn calls:
    the geo forward's node cloud against itself, raster calls: one a
    step)``."""
    cfg = kitti_config(compute_dtype="bfloat16")
    batch, model, agent, _ = serve.build_workload(cfg, B, seed=0)
    serve.centre_overlap_head_(model, batch)
    raster = []
    knn = capture_calls("knn", lambda: raster.extend(capture_calls(
        "segment_mean_count_image_project",
        lambda: serve.serve_episode(model, agent, cfg, batch))))
    del batch, model, agent
    torch.cuda.empty_cache()
    return knn, raster


def check_refusals(torch, kernels, dev) -> None:
    """Kernels 3 and 4 raise on shapes they cannot take, count no launch
    and fall back to nothing: knn past N = 4096 or k = 32, the raster with
    an unsupported compute dtype or F past a block's shared memory
    (``[refusal]``)."""
    before = kernels.launch_counts()
    xyz = torch.zeros(1, kernels.KNN_MAX_POINTS + 1, 3, device=dev)
    pcT = torch.ones(1, 3, 64, device=dev)
    eye = torch.tensor([[1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0]], device=dev)
    counts = torch.full((1,), 64, dtype=torch.int32, device=dev)
    wide = torch.zeros(1, 64, 60000, device=dev)
    cases = {
        "knn_n_4097": (ValueError, lambda: kernels.knn(xyz, xyz[:, :8], 4)),
        "knn_k_33": (ValueError, lambda: kernels.knn(xyz[:, :64],
                                                     xyz[:, :8], 33)),
        "raster_f16": (ValueError, lambda: kernels.
                       segment_mean_count_image_project(
                           pcT, wide[..., :8].contiguous(), eye, counts, 4,
                           4, torch.float16)),
    }
    for mode, dt in RASTER_MODES:
        cases[f"raster_f60000_{mode}"] = (
            RuntimeError, lambda dt=dt: kernels.segment_mean_count_image_project(
                pcT, wide, eye, counts, 4, 4,
                None if dt is None else getattr(torch, dt)))
    for name, (kind, fn) in cases.items():
        try:
            fn()
        except kind as e:
            line("refusal", case=name, raised=type(e).__name__,
                 message=repr(str(e)[:90]))
        else:
            raise AssertionError(f"{name}: no {kind.__name__}")
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before


def check_knn_raster(torch, kernels, serve, kitti_config, dev):
    """Phase 16 (``--phase knn_raster``): kernels 3 and 4 on their edge
    cases and on their paths' own calls (:func:`episode_path_calls`). knn
    (``[knn_case]``): equal to its plain version in full order and
    bit-equal across launches on every case of :func:`knn_cases`, timed at
    the serving shape and on the geo forward's call. Kernel 4 (``[raster_mode]``): :func:`raster_modes` on
    every case of :func:`raster_cases`, timed on phase 3's cloud; then the
    10 calls of one bf16 + int8 episode (``[raster_path]``: each held in
    all three modes, its own int8 call timed; ``[raster_path_total]``: the
    10 calls' wrapper, device and plain times); then
    :func:`check_refusals`."""
    from cmr_agent_tpu_torch.ops import build
    print_ptxas(build, "knn", KNN_KERNEL_NAMES, int_template)
    print_ptxas(build, "raster", RASTER_KERNEL_NAMES, raster_variant)
    t0 = time.perf_counter()
    geo_calls, ep_calls = episode_path_calls(torch, serve, kitti_config)
    line("knn_raster_capture", seconds=f"{time.perf_counter() - t0:.1f}",
         geo_forward_knn_calls=len(geo_calls),
         episode_raster_calls=len(ep_calls))
    gen = torch.Generator().manual_seed(808)
    rows = {}
    for kind, xyz, query, k in knn_cases(torch, gen, dev, geo_calls):
        timed = kind == "serving" or kind.startswith("geo_forward")
        r = knn_row(torch, kernels, xyz, query, k, timed)
        line("knn_case", kind=kind, shape=repr(r["shape"]), equal_plain=True,
             same_bits=True, kernel_ms=f"{r['ms']:.5f}",
             **({} if not timed else dict(device_ms=fmt_ms(r["device_ms"]),
                                          host_us=f"{r['host_us']:.1f}")))
        if timed:
            rows[f"knn[{kind}]"] = r
    print_rows(rows)
    del geo_calls
    for kind, *args in raster_cases(torch, gen, dev):
        modes = raster_modes(torch, kernels, *args, kind,
                             timed=kind == "phase3")
        landed = {r["landed"] for r in modes.values()}
        if kind in ("one_pixel", "every_pixel"):
            assert landed == {B * RASTER_K}, (kind, landed)
        elif kind == "behind_camera":
            assert landed == {0}, (kind, landed)
    hold_raster_path(torch, kernels, ep_calls)
    check_refusals(torch, kernels, dev)


def hold_raster_path(torch, kernels, calls) -> None:
    """Kernel 4 on the calls of one bf16 + int8 episode: each call's
    inputs held in all three modes (:func:`raster_modes`, untimed) and its
    own call timed (``[raster_path]``); then all calls in turn
    (``[raster_path_total]``: wrapper, device, plain)."""
    fn, plain = (kernels.segment_mean_count_image_project,
                 kernels.PLAIN["segment_mean_count_image_project"])
    for i, (args, kw) in enumerate(calls):
        pcT, feat, ab, counts, h, w = args
        modes = raster_modes(torch, kernels, pcT, feat, ab, counts, h, w,
                             f"episode_{i}", timed=False)
        line("raster_path", call=i, feat_dtype=str(feat.dtype).replace(
            "torch.", ""), compute_dtype=str(kw.get("compute_dtype")),
             valid_rows=int(counts.sum()),
             landed=modes["int8"]["landed"], int8_equal=True,
             kernel_ms=f"{cuda_ms(lambda: fn(*args, **kw), 5):.5f}")

    def each(f):
        return lambda: [f(*args, **kw) for args, kw in calls]
    line("raster_path_total", calls=len(calls),
         kernel_ms=f"{cuda_ms(each(fn), 5):.5f}",
         device_ms=fmt_ms(kernel_device_ms(each(fn), RASTER_KERNEL_NAMES,
                                           iters=3)),
         host_us=f"{host_us(torch, each(fn), iters=10):.1f}",
         plain_ms=f"{cuda_ms(each(plain), 2):.5f}")


# kernel 1's and kernel 6a's kernels, by name, for their device time
SOFTMAX_KERNEL_NAMES = ("softmax_max_kernel", "softmax_bucket_kernel",
                        "softmax_reduce_kernel")


def softmax_bound(attn, m: int):
    """Kernel 1's bound: attn and values read once in their dtype, the ids,
    the [B, M, F] output written (the residual sums, which the serving
    path does not need, not counted); 6 operations an element."""
    b, n, f = attn.shape
    nbytes = 2 * b * n * f * attn.element_size() + b * n * 4 + b * m * f * 4
    return bound(nbytes, 6.0 * b * n * f)


def softmax_cases(torch, gen):
    """Kernel 1's edge cases, on the CPU: ``(kind, attn, values, idx, M)``
    for :func:`segment_id_maps` at ``SEGMENT_CASE_SHAPES`` (the first at
    full width), plus a segment whose logits lie 1000 below its sample's
    max (exp underflows: its output is 0)."""
    cases = []
    for b, n, m_, f in SEGMENT_CASE_SHAPES:
        attn = torch.randn(b, n, f, generator=gen) * 2
        values = torch.randn(b, n, f, generator=gen)
        for kind, (ix, m) in segment_id_maps(torch, gen, b, n, m_).items():
            cases.append((f"{kind}[{n},{f}]", attn, values, ix, m))
        ix = torch.randint(0, m_, (b, n), generator=gen, dtype=torch.int32)
        ix[:, :5] = 3
        under = attn.clone()
        under[ix == 3] -= 1000.0
        cases.append((f"underflow[{n},{f}]", under, values, ix, m_))
    return cases


def hold_softmax(torch, kernels, attn, values, idx, m: int, label: str):
    """Kernel 1 on one call against its plain version: out and sums within
    rtol 1e-5 atol 1e-6 (f32 sums in another order, expf within 2 ulp of
    the correctly rounded exp), gmax equal; the same bits on a second
    launch; a bf16 call (the call's own, or its operands rounded to bf16)
    ``torch.equal`` to the f32 call on the widened operands. Returns the
    largest error of out."""
    got = kernels.segment_softmax_attend(attn, values, idx, m,
                                         return_stats=True)
    want = kernels.segment_softmax_attend_plain(attn, values, idx, m,
                                                return_stats=True)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert torch.equal(got[2], want[2]), label
    err = (got[0] - want[0]).abs().max().item() if got[0].numel() else 0.0
    del want
    again = kernels.segment_softmax_attend(attn, values, idx, m,
                                           return_stats=True)
    assert all(torch.equal(a, g) for a, g in zip(again, got)), label
    del again
    a16, v16 = attn.bfloat16(), values.bfloat16()
    g16 = kernels.segment_softmax_attend(a16, v16, idx, m, return_stats=True)
    w16 = kernels.segment_softmax_attend(a16.float(), v16.float(), idx, m,
                                         return_stats=True)
    assert all(torch.equal(x, y) for x, y in zip(g16, w16)), label
    return err


def softmax_timed_row(torch, kernels, attn, values, idx, m: int, shape: str,
                      tol: str):
    """Wrapper, device, host and plain times of one kernel 1 call, with its
    bound."""
    def fn():
        return kernels.segment_softmax_attend(attn, values, idx, m)
    return dict(
        max_abs_err=hold_softmax(torch, kernels, attn, values, idx, m,
                                 shape),
        tol=tol, shape=shape, library_ms=None, ms=cuda_ms(fn, 20),
        device_ms=kernel_device_ms(fn, SOFTMAX_KERNEL_NAMES),
        host_us=host_us(torch, fn),
        plain_ms=cuda_ms(lambda: kernels.segment_softmax_attend_plain(
            attn, values, idx, m), 5),
        bound=softmax_bound(attn, m))


def geo_forward_softmax_calls(torch, serve, kitti_config, dtype: str):
    """Kernel 1's calls in one geo forward (KITTI width, B=8, random
    weights, seed 0) in ``dtype``, captured."""
    cfg = kitti_config(compute_dtype=dtype)
    batch, model, _, _ = serve.build_workload(cfg, B, seed=0)
    with torch.inference_mode():
        calls = capture_calls("segment_softmax_attend", lambda: model(batch))
    del batch, model
    torch.cuda.empty_cache()
    return calls


def check_softmax_backward(torch, kernels, attn, values, idx, m: int):
    """The backward kernel on the new forward's residuals (one of the geo
    forward's calls, rows routed out both ways) against autograd of the
    plain forward, as phase 5 holds it: rtol 1e-4, atol 1e-5 max|grad|;
    then ``SegmentSoftmaxAttendFn`` on bf16 leaves: bf16 gradients within
    one bf16 rounding (rtol 2^-7) of autograd of the plain version on the
    same leaves."""
    idx = routed_out(idx, m)
    g = torch.randn(attn.shape[0], m, attn.shape[-1],
                    generator=torch.Generator().manual_seed(17)).to(
        attn.device)
    out, sums, gmax = kernels.segment_softmax_attend(attn, values, idx, m,
                                                     return_stats=True)
    got = kernels.segment_softmax_attend_backward(attn, values, idx, out,
                                                  sums, gmax, g, m)
    a_, v_ = (t.detach().clone().requires_grad_() for t in (attn, values))
    kernels.segment_softmax_attend_plain(a_, v_, idx, m).backward(g)
    for a, b in zip(got, (a_.grad, v_.grad)):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * b.abs().max().item())
    diffs = [(a - b).abs().max().item() for a, b in zip(got, (a_.grad,
                                                             v_.grad))]
    a16, v16 = (t.detach().bfloat16().requires_grad_() for t in (attn,
                                                                 values))
    kernels.SegmentSoftmaxAttendFn.apply(a16, v16, idx, m).backward(g)
    p16, q16 = (t.detach().bfloat16().requires_grad_() for t in (attn,
                                                                 values))
    kernels.segment_softmax_attend_plain(p16, q16, idx, m).backward(g)
    for a, b in ((a16.grad, p16.grad), (v16.grad, q16.grad)):
        assert a.dtype == torch.bfloat16, a.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=2.0 ** -7,
                                   atol=1e-5 * b.float().abs().max().item())
    line("softmax_backward", shape=f"[{attn.shape[0]},{attn.shape[1]},"
         f"{attn.shape[2]}]->{m}", tol="rtol 1e-4 atol 1e-5 max|g| vs "
         "autograd of the plain forward; bf16 leaves within one bf16 "
         "rounding", max_abs_diff_dattn=diffs[0], max_abs_diff_dvalues=diffs[1],
         bf16_grad_dtype="bfloat16")


def check_softmax_kernel(torch, kernels, serve, kitti_config, dev):
    """Phase 17, kernel 1: :func:`hold_softmax` on every case of
    :func:`softmax_cases` (``[softmax_case]``), timed at the serving shape
    on f32 and bf16 operands; on the 4 calls of one f32 and one bf16 geo
    forward (``[softmax_path]`` per call, ``[softmax_path_total]``:
    wrapper, device, host and plain times); the backward on the new
    residuals. Returns the rows at the serving shape."""
    gen = torch.Generator().manual_seed(909)
    for kind, attn, values, ix, m in softmax_cases(torch, gen):
        attn, values, ix = attn.to(dev), values.to(dev), ix.to(dev)
        err = hold_softmax(torch, kernels, attn, values, ix, m, kind)
        ms = cuda_ms(lambda: kernels.segment_softmax_attend(attn, values, ix,
                                                            m), 3)
        line("softmax_case", kind=kind, m=m, max_abs_err=err,
             same_bits=True, bf16_equals_widened=True, kernel_ms=f"{ms:.5f}")
        if kind.startswith("underflow"):
            out = kernels.segment_softmax_attend(attn, values, ix, m)
            assert not out[:, 3].any(), kind
    del attn, values, ix
    _, randn, randint = rand_factory(torch, 1234, dev)
    attn, values = randn(B, N_PT, F, scale=2.0), randn(B, N_PT, F)
    idx = randint(0, N_NODE, B, N_PT)
    tol = ("rtol 1e-5 atol 1e-6 (f32 sums in a fixed order, expf); gmax "
           "equal; same bits on a second launch; bf16 equal to the f32 "
           "call on the widened operands")
    rows = {}
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        r = softmax_timed_row(torch, kernels, attn.to(dt), values.to(dt),
                              idx, N_NODE, f"[{B},{N_PT},{F}] {tag} -> "
                              f"[{B},{N_NODE},{F}]", tol)
        rows[tag] = r
        print_rows({f"segment_softmax_attend[{tag}]": r})
    del attn, values, idx
    fn, plain = (kernels.segment_softmax_attend,
                 kernels.PLAIN["segment_softmax_attend"])
    for dtype in ("float32", "bfloat16"):
        calls = geo_forward_softmax_calls(torch, serve, kitti_config, dtype)
        assert len(calls) == 4, len(calls)
        for i, (args, kw) in enumerate(calls):
            attn, values, idx, m = args
            err = hold_softmax(torch, kernels, attn, values, idx, m,
                               f"geo_{dtype}_{i}")
            flat = idx.long()
            counts = torch.zeros(B, m + 1, dtype=torch.long, device=dev
                                 ).scatter_add_(1, torch.where(
                                     (flat >= 0) & (flat < m), flat, m),
                                     torch.ones_like(flat))[:, :m]
            line("softmax_path", forward=dtype, call=i,
                 operands=str(attn.dtype).replace("torch.", ""),
                 shape=f"[{B},{attn.shape[1]},{attn.shape[2]}]->{m}",
                 max_rows_per_segment=int(counts.max()), max_abs_err=err,
                 same_bits=True,
                 kernel_ms=f"{cuda_ms(lambda: fn(*args, **kw), 5):.5f}")

        def each(f):
            return lambda: [f(*args, **kw) for args, kw in calls]
        line("softmax_path_total", forward=dtype, calls=len(calls),
             kernel_ms=f"{cuda_ms(each(fn), 5):.5f}",
             device_ms=fmt_ms(kernel_device_ms(each(fn), SOFTMAX_KERNEL_NAMES,
                                               iters=3)),
             host_us=f"{host_us(torch, each(fn), iters=10):.1f}",
             plain_ms=f"{cuda_ms(each(plain), 2):.5f}")
        if dtype == "float32":
            args = calls[0][0]
            check_softmax_backward(torch, kernels, *args)
        del calls
        torch.cuda.empty_cache()
    return rows


def image_bound(data, ids, landed: int, hw: int, mode: str):
    """Kernel 6a's bound: every id, the landing rows' features (int8: all
    K rows', which the absmax reads) in their given dtype and the output,
    each once; F + 1 adds a landing row."""
    b, k, f = data.shape
    feat_rows = b * k if mode == "int8" else landed
    nbytes = (b * k * 4 + feat_rows * f * data.element_size()
              + b * hw * (f + 1) * 4)
    return bound(nbytes, (f + 1.0) * landed)


def image_modes(torch, kernels, data, ids, h: int, w: int, label: str,
                timed: bool = False, project=None):
    """Kernel 6a against its plain version in f32, bf16 and int8 on one
    input: counts exact, int8 means bit-equal, f32 / bf16 means within
    rtol 1e-5 atol 1e-6, every mode the same bits on a second launch; with
    ``project`` (``(pcT, ab, counts)`` whose projection gave ``ids``) equal
    bit for bit to kernel 4, which runs the same band kernel on the same
    rows. With ``timed`` each mode's wrapper, device, host and plain times
    and bound. Returns ``{mode: row}``; one ``[image_mode]`` line a
    mode."""
    out = {}
    for mode, dt in RASTER_MODES:
        cdt = None if dt is None else getattr(torch, dt)
        args = (data, ids, h, w, cdt)
        gm, gc = kernels.segment_mean_count_image(*args)
        wm, wc = kernels.segment_mean_count_image_plain(*args)
        assert torch.equal(gc, wc), (label, mode)
        err = (gm - wm).abs().max().item() if gm.numel() else 0.0
        if mode == "int8":
            assert torch.equal(gm, wm), (label, mode, err)
        else:
            torch.testing.assert_close(gm, wm, rtol=1e-5, atol=1e-6)
        gm2, gc2 = kernels.segment_mean_count_image(*args)
        assert torch.equal(gm2, gm) and torch.equal(gc2, gc), (label, mode)
        if project is not None:
            pcT, ab, counts = project
            pm, pc = kernels.segment_mean_count_image_project(
                pcT, data, ab, counts, h, w, cdt)
            assert torch.equal(pm, gm) and torch.equal(pc, gc), (label, mode)
            del pm, pc
        r = dict(max_abs_err=err, landed=int(wc.sum()), library_ms=None)
        del gm, gc, wm, wc, gm2, gc2

        def fn():
            return kernels.segment_mean_count_image(*args)
        if timed:
            r.update(ms=cuda_ms(fn, 20),
                     device_ms=kernel_device_ms(fn, RASTER_KERNEL_NAMES),
                     host_us=host_us(torch, fn),
                     plain_ms=cuda_ms(lambda: kernels.
                                      segment_mean_count_image_plain(*args),
                                      5),
                     bound=image_bound(data, ids, r["landed"], h * w, mode))
        line("image_mode", case=label, mode=mode, data_dtype=str(
            data.dtype).replace("torch.", ""), landed=r["landed"],
             max_abs_err=err, same_bits=True,
             equal_kernel4=project is not None,
             **({} if not timed else dict(
                 kernel_ms=f"{r['ms']:.5f}",
                 device_ms=fmt_ms(r["device_ms"]),
                 host_us=f"{r['host_us']:.1f}",
                 plain_ms=f"{r['plain_ms']:.5f}",
                 bound_us=f"{r['bound'][0] * 1e3:.2f}({r['bound'][1]})")))
        out[mode] = r
    return out


def hold_image_path(torch, kernels, label: str, calls) -> None:
    """Kernel 6a on the calls a path made: each call's inputs held in all
    three modes (:func:`image_modes`) and its own call timed
    (``[image_path]``); then all calls in turn (``[image_path_total]``:
    wrapper, device, host and plain times)."""
    fn, plain = (kernels.segment_mean_count_image,
                 kernels.PLAIN["segment_mean_count_image"])
    for i, (args, kw) in enumerate(calls):
        data, ids, h, w = args[:4]
        cdt = args[4] if len(args) > 4 else kw.get("compute_dtype")
        modes = image_modes(torch, kernels, data, ids, h, w,
                            f"{label}_{i}")
        line("image_path", path=label, call=i, data_dtype=str(
            data.dtype).replace("torch.", ""), compute_dtype=str(cdt),
             landed=modes["f32"]["landed"],
             kernel_ms=f"{cuda_ms(lambda: fn(*args, **kw), 5):.5f}")

    def each(f):
        return lambda: [f(*args, **kw) for args, kw in calls]
    line("image_path_total", path=label, calls=len(calls),
         kernel_ms=f"{cuda_ms(each(fn), 5):.5f}",
         device_ms=fmt_ms(kernel_device_ms(each(fn), RASTER_KERNEL_NAMES,
                                           iters=3)),
         host_us=f"{host_us(torch, each(fn), iters=10):.1f}",
         plain_ms=f"{cuda_ms(each(plain), 2):.5f}")


def check_image_profile(torch, kernels, data, ids) -> None:
    """One int8 call of kernel 6a under ``torch.profiler``: every kernel it
    ran is one of the port's (no PyTorch quantisation or zero fill;
    ``[image_profile]``)."""
    def fn():
        return kernels.segment_mean_count_image(data, ids, IMG_H, IMG_W,
                                                torch.int8)
    fn()
    for _ in range(3):   # the profiler now and then returns no rows
        by_name, _ = profile_device(fn)
        if by_name:
            break
    names = sorted(by_name)
    line("image_profile", mode="int8", kernels=repr(",".join(
        k[:40] for k in names)) if names else "not measured")
    assert all(any(n in k for n in RASTER_KERNEL_NAMES) for k in names), \
        names


def check_softmax_image_refusals(torch, kernels, dev) -> None:
    """Kernels 1 and 6a raise on what they cannot take and count no launch:
    kernel 1 past 65535 segments, with offsets past a block's shared
    memory, on f16 or mixed operands; 6a with an unsupported compute dtype
    or F past a block's shared memory (``[refusal]``)."""
    before = kernels.launch_counts()
    a = torch.zeros(1, 64, 8, device=dev)
    ix = torch.zeros(1, 64, dtype=torch.int32, device=dev)
    wide = torch.zeros(1, 64, 60000, device=dev)
    cases = {
        "softmax_m_65536": (RuntimeError, lambda: kernels.
                            segment_softmax_attend(a, a, ix, 65536)),
        "softmax_m_60000": (RuntimeError, lambda: kernels.
                            segment_softmax_attend(a, a, ix, 60000)),
        "softmax_f16": (TypeError, lambda: kernels.segment_softmax_attend(
            a.half(), a.half(), ix, 4)),
        "softmax_mixed": (TypeError, lambda: kernels.segment_softmax_attend(
            a, a.bfloat16(), ix, 4)),
        "image_f16": (ValueError, lambda: kernels.segment_mean_count_image(
            a, ix, 4, 4, torch.float16)),
    }
    for mode, dt in RASTER_MODES:
        cases[f"image_f60000_{mode}"] = (
            RuntimeError, lambda dt=dt: kernels.segment_mean_count_image(
                wide, ix, 4, 4, None if dt is None else getattr(torch, dt)))
    for name, (kind, fn) in cases.items():
        try:
            fn()
        except kind as e:
            line("refusal", case=name, raised=type(e).__name__,
                 message=repr(str(e)[:90]))
        else:
            raise AssertionError(f"{name}: no {kind.__name__}")
    torch.cuda.synchronize()
    assert kernels.launch_counts() == before


def check_softmax_image(torch, kernels, serve, kitti_config, dev):
    """Phase 17 (``--phase softmax_image``): kernel 1
    (:func:`check_softmax_kernel`), then kernel 6a: :func:`image_modes` on
    every case of :func:`raster_cases`, its ids projected by the plain
    projection (and kernel 4 on the same case equal bit for bit), timed at
    the training shape (phase 5's ids); on the 40 calls of one
    agent-training run and the 10 of one "flat" bf16 + int8 episode
    (:func:`hold_image_path`); a profile of one int8 call; then
    :func:`check_softmax_image_refusals`. Returns the kernel 1 rows at
    the serving shape and the 6a rows at the training shape."""
    from cmr_agent_tpu_torch.ops import build
    print_ptxas(build, "segment_softmax", SOFTMAX_KERNEL_NAMES,
                raster_variant)
    print_ptxas(build, "raster", RASTER_KERNEL_NAMES, raster_variant)
    softmax_rows = check_softmax_kernel(torch, kernels, serve, kitti_config,
                                        dev)
    gen = torch.Generator().manual_seed(1717)
    for kind, pcT, feat, ab, counts, h, w in raster_cases(torch, gen, dev):
        ids = kernels._project_pixels(pcT, ab, counts, h, w).to(torch.int32)
        modes = image_modes(torch, kernels, feat, ids, h, w, kind,
                            project=(pcT, ab, counts))
        landed = {r["landed"] for r in modes.values()}
        if kind in ("one_pixel", "every_pixel"):
            assert landed == {B * RASTER_K}, (kind, landed)
        elif kind == "behind_camera":
            assert landed == {0}, (kind, landed)
    hw = IMG_H * IMG_W
    ids = train_raster_ids(B, RASTER_K, hw, gen).to(dev)
    data = torch.randn(B, RASTER_K, F, generator=gen).to(dev)
    image_rows = image_modes(torch, kernels, data, ids, IMG_H, IMG_W,
                             "training_shape", timed=True)
    check_image_profile(torch, kernels, data, ids)
    del data, ids
    cfg = kitti_config()
    hold_image_path(torch, kernels, "agent_train",
                    agent_raster_calls(cfg, B, dev))
    torch.cuda.empty_cache()
    hold_image_path(torch, kernels, "flat_episode",
                    flat_episode_raster_calls(cfg, B, dev))
    torch.cuda.empty_cache()
    check_softmax_image_refusals(torch, kernels, dev)
    return softmax_rows, image_rows


def check_compact_pack(torch, kernels, serve, kitti_config, dev) -> None:
    """``--phase compact_pack``: kernel 11's gates and times from phase 8
    (:func:`check_pack_kernel`), then kernel 8's from phase 14 on the calls
    of one f32 and one bf16 + int8 "compact" episode, the overlap head
    centred (:func:`check_compact_calls`)."""
    from cmr_agent_tpu_torch.ops import build
    print_ptxas(build, "mask_pack", PACK_KERNEL_NAMES, chunk_variant)
    print_ptxas(build, "raster", RASTER_KERNEL_NAMES, raster_variant)
    gen, randn, _ = rand_factory(torch, 777, dev)
    check_pack_kernel(torch, kernels, gen, randn)
    torch.cuda.empty_cache()
    calls = {}
    for dtype in ("float32", "bfloat16"):
        cfg = kitti_config(raster_mode="compact", compute_dtype=dtype)
        batch, model, agent, episode = serve.build_workload(cfg, B, seed=0)
        serve.centre_overlap_head_(model, batch)
        calls[dtype] = recorded_calls(
            kernels, "segment_sum_count_image_compact",
            lambda: episode(batch))
        del batch, model, agent, episode
    check_compact_calls(torch, kernels, calls)


# the flagship evaluation (runs_r5/README.md, E7), as the JAX package's
# command gives it, on the card
E7_ARGV = ("--dataset synthetic --synthetic-scene structured "
           "--synthetic-length 64 --dtype bfloat16 "
           "--iter-ckpt checkpoint/iter_kitti/epoch-1-step-10000 "
           "--geo-ckpt runs_r4/geo_pi --fine-geo-ckpt runs_r4/geo_45 "
           "--agent-ckpt runs_r4/agent_45 --unmasked-warp --pose-aware "
           "--aux-head --bearing-init --hypo-score combo --refine-rounds 1 "
           "--eval-batch-size 8 --iter-hypotheses 13 "
           "--refine-beam combo,mean_valid,ir_smooth "
           "--beam-score above50_norm").split()
# the JAX package's published E7 accuracy (runs_r5/README.md:40-41): 47 of
# 64 scenes, a 48-scene ceiling
E7_PUBLISHED = dict(registration_recall=0.734, rr_any_hypothesis=0.750,
                    rte_median_all=0.69, rre_median_all=0.78)
EVAL_KERNELS = ("segment_softmax_attend", "gather_rows", "knn",
                "segment_mean_count_image_project", "segment_sum_shared")
# the twin's gates: phase 4's f32 logit tolerance, a pose to 1e-4; raw
# verification statistics (cosine means, point shares) to 1e-3; the
# z-scored combo and the selections by it at phase 10's 2e-2
EVAL_STAT_TOL, EVAL_Z_TOL = 1e-3, 2e-2


# sha256 of E7's 64 test scenes (every key's bytes, in key order, scene by
# scene), as both packages' build_dataset give them on the host where
# tests/test_torch_checkpoint.py holds them equal
E7_SPLIT_SHA256 = ("39051e55607d4342e31c0cf72a6892ad"
                   "232ddd422d8661cfeb1fcf49bc542dd3")


def e7_split_digest() -> str:
    """sha256 of E7's test split as ``cli.common.build_dataset`` builds it
    on this host (the native FPS and 1-NN are compiled here)."""
    import argparse
    import hashlib

    from cmr_agent_tpu_torch.cli.common import build_dataset
    from cmr_agent_tpu_torch.config import kitti_config
    from cmr_agent_tpu_torch.data.loader import DataLoader
    ds = build_dataset(kitti_config(), argparse.Namespace(
        dataset="synthetic", tiny=False, synthetic_length=64, val_length=0,
        synthetic_scene="structured"), "test")
    h = hashlib.sha256()
    for batch in DataLoader(ds, 1, num_workers=8):
        for k in sorted(batch):
            h.update(k.encode() + np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


def e7_argv(dev, *extra, dtype=None):
    argv = list(E7_ARGV) + ["--device", str(dev)]
    if dtype is not None:
        argv[argv.index("--dtype") + 1] = dtype
    return argv + list(extra)


def check_weights(torch, dev):
    """``[weights]``: each committed export's sha256 against the manifest,
    its leaves and bytes, and the time to read it and load it into its
    module on the card (numpy and torch only)."""
    from cmr_agent_tpu_torch.config import kitti_config
    from cmr_agent_tpu_torch.models.agent import CMRAgent
    from cmr_agent_tpu_torch.models.cost_volume import IterModel
    from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
    from cmr_agent_tpu_torch.train import checkpoint
    cfg = kitti_config(**FLAGSHIP_CFG)
    modules = {"multihead": MultiHeadModel, "agent": CMRAgent,
               "itermodel": IterModel}
    for stem, entry in sorted(checkpoint.manifest().items()):
        path = checkpoint.WEIGHTS_DIR / entry["file"]
        sha_ok = checkpoint.file_sha256(path) == entry["sha256"]
        assert sha_ok, (stem, "sha256 differs from the manifest")
        which = ("agent" if stem.startswith("agent") else "itermodel"
                 if stem.startswith("iter") else "multihead")
        module = modules[which](cfg).to(dev)
        t0 = time.perf_counter()
        variables = checkpoint.restore_model_variables(str(path))
        checkpoint.load_module_variables(module, cfg, variables, which)
        torch.cuda.synchronize()
        line("weights", file=entry["file"], orbax=entry["orbax"],
             leaves=entry["leaves"], bytes=entry["bytes"], sha256_ok=sha_ok,
             load_s=f"{time.perf_counter() - t0:.3f}",
             step=int(variables["step"]) if "step" in variables else "none")


def compare_candidate(torch, got_steps, want_steps, rows, atol: float):
    """Phase 4's episode gate (``compare_episodes``) on the samples
    ``rows`` of one candidate: each step's logits within ``atol``, its
    actions equal where the top-2 margin exceeds ``atol``, while a
    sample's action history agrees. Returns (max logit diff, the samples
    whose history agreed throughout)."""
    agree, max_diff = rows.clone(), 0.0
    for (gr, gt), (wr, wt) in zip(got_steps, want_steps):
        if not agree.any():
            break
        for g, w in ((gr, wr), (gt, wt)):
            diff = (g - w).abs()[agree].max().item()
            max_diff = max(max_diff, diff)
            assert diff <= atol, f"logits differ by {diff} > {atol}"
            top2 = torch.topk(w, 2, dim=-1).values
            sure = (top2[..., 0] - top2[..., 1] > atol) & agree[:, None]
            assert torch.equal(g.argmax(-1)[sure], w.argmax(-1)[sure])
        agree &= ((gr.argmax(-1) == wr.argmax(-1)).all(-1)
                  & (gt.argmax(-1) == wt.argmax(-1)).all(-1))
    return max_diff, agree


def run_eval_twin(torch, kernels, dev):
    """``[eval_twin]``: the first E7 batch in f32 through ``cli.test_agent``'s
    path with the kernels and with their plain versions. Every candidate's
    coarse pose is held to 1e-4, its episode to phase 4's f32 gate and its
    final pose to 1e-4 where its actions agreed; its verification
    statistics then to ``EVAL_STAT_TOL``; a sample whose candidates all
    agreed has its combo scores held to ``EVAL_Z_TOL`` and the pose its
    selection picks to 1e-4 where the plain twin's margin exceeds that;
    where the beam members' statistics agree too and the re-vote's margin
    exceeds ``EVAL_STAT_TOL``, its final RTE / RRE to 1e-3 m / 1e-2 deg."""
    from cmr_agent_tpu_torch.cli import test_agent
    from cmr_agent_tpu_torch.cli.common import to_device
    _, _, loader, evaluate = test_agent.prepare(
        e7_argv(dev, "--synthetic-length", "8", dtype="float32"))
    batch = to_device(next(iter(loader)), dev)
    got = evaluate(batch)
    with plain_kernels(kernels):
        want = evaluate(batch)
    b, k = want["hypo_rte"].shape
    coarse = (got["cand_coarse"] - want["cand_coarse"]).abs().amax((2, 3))
    c_agree = coarse <= 1e-4                                    # [B, K]
    assert bool(c_agree.all()), coarse.tolist()
    logit_diff, pose_diff, same = 0.0, 0.0, torch.zeros_like(c_agree)
    for j in range(k):
        diff, hist = compare_candidate(torch, got["cand_steps"][j],
                                       want["cand_steps"][j], c_agree[:, j],
                                       1e-3)
        logit_diff = max(logit_diff, diff)
        if hist.any():
            d = (got["cand_final"][:, j] - want["cand_final"][:, j]
                 ).abs().amax((1, 2))[hist].max().item()
            assert d <= 1e-4, (j, d)
            pose_diff = max(pose_diff, d)
        same[:, j] = hist
    same = same.cpu().numpy()
    stat_diff = max(float(np.abs(got["hypo_stats"][s] - want["hypo_stats"][s]
                                 )[same].max(initial=0.0))
                    for s in want["hypo_stats"] if s != "combo")
    assert stat_diff <= EVAL_STAT_TOL, stat_diff
    whole = same.all(axis=1)                                    # [B]
    combo_w = want["hypo_stats"]["combo"]
    z_diff = float(np.abs(got["hypo_stats"]["combo"] - combo_w)[whole].max(
        initial=0.0))
    assert z_diff <= EVAL_Z_TOL, z_diff
    # a selection is held by the pose it picks: candidates that reach one
    # pose (the yaw grid closes on itself at pi) score alike to rounding,
    # and distinct_margin passes over them
    margin = distinct_margin(torch, torch.from_numpy(combo_w)).numpy()
    # (a margin of inf: every candidate scores alike, and any may be picked)
    sure = whole & (margin > EVAL_Z_TOL) & np.isfinite(margin)
    rows = torch.arange(b, device=got["cand_final"].device)

    def picked(rec):
        sel = torch.as_tensor(rec["sel"], device=rows.device)
        return torch.cat([rec["cand_coarse"][rows, sel],
                          rec["cand_final"][rows, sel]], dim=1)

    sel_diff = (picked(got) - picked(want)).abs().amax((1, 2)).cpu().numpy()
    assert (sel_diff[sure] <= 1e-4).all(), (got["sel"], want["sel"], margin,
                                            sel_diff)
    # the beam re-vote, where every member's statistics agree and the
    # margin over the next differently scoring member exceeds the tolerance
    beam_w = want["beam_stats"]["above50_norm"]
    beam_agree = whole & np.all(
        [np.abs(got["beam_stats"][s] - want["beam_stats"][s]).max(axis=1)
         <= EVAL_STAT_TOL for s in want["beam_stats"] if s != "combo"],
        axis=0)
    beam_margin = distinct_margin(torch, torch.from_numpy(beam_w)).numpy()
    beam_sure = (beam_agree & (beam_margin > EVAL_STAT_TOL)
                 & np.isfinite(beam_margin))
    beam_same = ((np.abs(got["rte"] - want["rte"]) <= 1e-3)
                 & (np.abs(got["rre"] - want["rre"]) <= 1e-2))
    assert beam_same[beam_sure].all(), (got["beam_sel"], want["beam_sel"],
                                        beam_margin)
    line("eval_twin", dtype="float32", samples=b, candidates=b * k,
         coarse_agree=int(c_agree.sum()), history_agree=int(same.sum()),
         max_coarse_diff=coarse.max().item(), max_logit_diff=logit_diff,
         max_final_pose_diff=pose_diff, max_stat_diff=stat_diff,
         max_combo_diff=z_diff, selections_held=int(sure.sum()),
         same_index=int((got["sel"] == want["sel"]).sum()),
         max_selected_pose_diff=float(sel_diff.max()),
         selection_margins=",".join(f"{m:.3f}" for m in margin),
         beam_held=int(beam_sure.sum()),
         beam_same_index=int((got["beam_sel"] == want["beam_sel"]).sum()),
         beam_margins=",".join(f"{m:.4f}" for m in beam_margin),
         max_rte_diff=float(np.abs(got["rte"] - want["rte"]).max()),
         max_rre_diff=float(np.abs(got["rre"] - want["rre"]).max()),
         solved_kernels=int(((got["rte"] < 5) & (got["rre"] < 10)).sum()),
         solved_plain=int(((want["rte"] < 5) & (want["rre"] < 10)).sum()))


def e7_batch_profile(torch, kernels, dev):
    """One bf16 E7 batch through ``cli.test_agent``'s path: each kernel's
    launches (``[eval_launches]``), its time and a profile. Returns the
    launches of the batch."""
    from cmr_agent_tpu_torch.cli import test_agent
    from cmr_agent_tpu_torch.cli.common import to_device
    _, _, loader, evaluate = test_agent.prepare(
        e7_argv(dev, "--synthetic-length", "8"))
    batch = to_device(next(iter(loader)), dev)
    evaluate(batch)                                           # warm-up
    kernels.reset_launch_counts()
    _, seconds = timed(torch, lambda: evaluate(batch))
    counts = kernels.launch_counts()
    line("eval_launches", dtype="bfloat16", per_batch=True,
         batch_s=f"{seconds:.3f}", **counts)
    assert all(counts[n] > 0 for n in EVAL_KERNELS), counts
    assert all(counts[n] == 0 for n in TRAINING_KERNELS), counts
    profile_call(torch, lambda: evaluate(batch),
                 unprofiled_ms=seconds * 1e3, phase="eval", dtype="bfloat16")
    return counts


def run_eval_agent(torch, kernels, dev, per_batch):
    """``[eval_agent]``: the E7 command through ``cli.test_agent.main``,
    its launches (one batch's times the number of batches) and peak
    memory, and
    ``[eval_scenes]``: the per-scene ``--save-mat`` fields as one JSON
    line."""
    import os
    import tempfile

    import scipy.io as scio
    from cmr_agent_tpu_torch.cli import test_agent
    with tempfile.TemporaryDirectory() as tmp:
        mat = os.path.join(tmp, "e7.mat")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(sys.stderr):
            m = test_agent.main(e7_argv(dev, "--save-mat", mat))
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        scenes = {k: np.round(v.astype(np.float64), 4).squeeze().tolist()
                  for k, v in scio.loadmat(mat).items()
                  if not k.startswith("__")}
    scenes_asked = int(E7_ARGV[E7_ARGV.index("--synthetic-length") + 1])
    assert m["num_samples"] == scenes_asked, m
    batches = scenes_asked // int(
        E7_ARGV[E7_ARGV.index("--eval-batch-size") + 1])
    assert counts == {n: batches * c for n, c in per_batch.items()}, \
        (counts, per_batch)
    assert all(np.isfinite(m[k]) for k in ("rte_median_all",
                                           "rre_median_all"))
    steady = m["avg_episode_time_steady_s"]
    line("eval_agent", dtype="bfloat16",
         registration_recall=m["registration_recall"],
         solved=round(m["registration_recall"] * m["num_samples"]),
         rr_any_hypothesis=m["rr_any_hypothesis"],
         rr_beam_any=m["rr_beam_any"], rr_selected=m["rr_selected"],
         rr_pre_refine=m["rr_pre_refine"],
         rte_median_all=m["rte_median_all"],
         rre_median_all=m["rre_median_all"],
         coarse_rte_mean=m["coarse_rte_mean"],
         num_samples=m["num_samples"],
         steady_s_per_pair=f"{steady:.5f}",
         pairs_per_s=f"{1 / steady:.3f}",
         first_batch_s_per_pair=f"{m['avg_episode_time_s']:.5f}",
         peak_gib=f"{peak / 2**30:.3f}",
         **{f"jax_published_{k}": v for k, v in E7_PUBLISHED.items()})
    line("eval_launches", dtype="bfloat16", batches=batches, **counts)
    print("[eval_scenes] " + json.dumps(scenes, separators=(",", ":")),
          flush=True)
    return counts


def run_eval_geo(torch, kernels, dev):
    """``[eval_geo]``: ``cli.test_geo`` on the structured test split in
    f32, ``--max-batches 8``: the geo model's matching inlier ratio and the
    cost volume's RTE / RRE."""
    from cmr_agent_tpu_torch.cli import test_geo
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        r, seconds = timed(torch, lambda: test_geo.main([
            "--dataset", "synthetic", "--synthetic-scene", "structured",
            "--synthetic-length", "64", "--geo-ckpt", "runs_r4/geo_pi",
            "--iter-ckpt", "checkpoint/iter_kitti/epoch-1-step-10000",
            "--unmasked-warp", "--max-batches", "8", "--device",
            str(dev)]))
    counts = kernels.launch_counts()
    assert r["num_samples"] == 8 and 0 < r["matching_inlier_ratio"] <= 1, r
    assert counts["segment_sum_shared"] > 0 and counts["knn"] == 8, counts
    line("eval_geo", dtype="float32", seconds=f"{seconds:.2f}", **r,
         knn_launches=counts["knn"],
         segment_sum_shared_launches=counts["segment_sum_shared"])


def run_eval(torch, kernels, dev) -> None:
    """The evaluation phase: the weights, E7's scenes, the f32 twin, one
    profiled bf16 batch, E7 and ``cli.test_geo``."""
    check_weights(torch, dev)
    t0 = time.perf_counter()
    digest = e7_split_digest()
    line("eval_split", scenes=64, sha256=digest,
         equal_to_the_jax_split=digest == E7_SPLIT_SHA256,
         seconds=f"{time.perf_counter() - t0:.2f}")
    assert digest == E7_SPLIT_SHA256, "E7's scenes differ from the JAX split"
    run_eval_twin(torch, kernels, dev)
    torch.cuda.empty_cache()
    per_batch = e7_batch_profile(torch, kernels, dev)
    torch.cuda.empty_cache()
    run_eval_agent(torch, kernels, dev, per_batch)
    torch.cuda.empty_cache()
    run_eval_geo(torch, kernels, dev)


EXPORT_DIR = "build/export"
# phase 4's workload (geo forward + episode) under these settings
EXPORT_PAIRS = (("f32", dict(compute_dtype="float32")),
                ("bf16", dict(compute_dtype="bfloat16")),
                ("fused_bf16", dict(compute_dtype="bfloat16",
                                    fused_stacks="all")))
# a fresh process that imports torch and the port only, with the
# exporting processes' matmul and cuDNN settings (TF32 off: an artifact's
# f32 convolutions follow the calling process's): it loads each artifact
# as its exporter writes it, writes the file "loaded", waits for the
# exporters' inputs and replays (the file "go"), then calls each artifact
# twice (its CUDA graph captured at the first call) and holds the replays
# to theirs, calls the first artifact again after every later capture;
# then the foreign modules it imported
EXPORT_LOAD_SCRIPT = r"""
import json, os, sys, time
import torch
from torch.utils import _pytree
from cmr_agent_tpu_torch.train.export import load_exported
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
d, names = sys.argv[1], sys.argv[2:]


def wait(path):
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > 3600:
            sys.exit("no " + path)
        time.sleep(0.5)


def leaves(tree):
    return _pytree.tree_leaves(tree)


programs = {}
for name in names:
    wait(os.path.join(d, name + ".pt2"))
    t0 = time.perf_counter()
    programs[name] = load_exported(os.path.join(d, name + ".pt2"))
    print(json.dumps(dict(artifact=name,
                          load_s=round(time.perf_counter() - t0, 3))),
          flush=True)
open(os.path.join(d, "loaded"), "w").close()
wait(os.path.join(d, "go"))
inputs, firsts = {}, {}
for name in names:
    path = os.path.join(d, name)
    inputs[name] = torch.load(path + ".inputs.pt", map_location="cuda")
    want = torch.load(path + ".outputs.pt", map_location="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = programs[name].call(inputs[name])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = programs[name].call(inputs[name])
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    firsts[name] = got
    pairs = list(zip(leaves(got), leaves(want)))
    print(json.dumps(dict(
        artifact=name, first_call_s=round(first_s, 3),
        replay_s=round(replay_s, 4),
        finite=all(bool(torch.isfinite(g.float()).all()) for g, _ in pairs),
        same_bits=all(torch.equal(g, w) for g, w in pairs),
        max_abs_diff=max((g.float() - w.float()).abs().max().item()
                         for g, w in pairs),
        replays_equal=all(torch.equal(a, g) for a, g in zip(
            leaves(again), leaves(got))))), flush=True)
first = names[0]
print(json.dumps(dict(first_after_later_captures=first,
                      captured_after=len(names) - 1, same_bits=all(
                          torch.equal(a, g) for a, g in zip(
                              leaves(programs[first].call(inputs[first])),
                              leaves(firsts[first]))))), flush=True)
print(json.dumps(dict(foreign_modules=sorted(
    m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "orbax", "cmr_agent_tpu")))), flush=True)
"""


def geo_state(geo_out, batch):
    """The episode artifact's inputs: the geo forward's outputs, the
    batch's cloud (the geo forward passes it through) and camera."""
    from cmr_agent_tpu_torch.train.export import EPISODE_KEYS
    state = {k: geo_out[k] for k in EPISODE_KEYS if k in geo_out}
    state.update(pc=batch["pc"], K=batch["K"])
    return state


def e7_composed(torch, dev, hypotheses: int):
    """E7's modules at the committed trained weights (as ``cli.test_agent``
    loads them), its first test batch (8 scenes, ``serve.COMPOSED_KEYS``)
    and the composed pipeline's options at ``hypotheses`` candidates:
    ``(cfg, (geo, iter_model, agent), inputs, options)``."""
    import argparse
    from cmr_agent_tpu_torch import serve
    from cmr_agent_tpu_torch.cli import common, test_agent
    from cmr_agent_tpu_torch.models.agent import CMRAgent
    from cmr_agent_tpu_torch.models.cost_volume import IterModel
    args = test_agent.parser().parse_args(e7_argv(dev, "--synthetic-length",
                                                  "8"))
    cfg = common.apply_obs_overrides(common.build_config(args), args)
    geo = common.load_geo_variables(cfg, args, dev)
    fine = common.load_geo_variables(
        cfg, argparse.Namespace(geo_ckpt=args.fine_geo_ckpt), dev)
    agent = common.load_model(cfg, CMRAgent(cfg), args.agent_ckpt, "agent",
                              "agent", dev)
    iter_model = common.load_model(cfg, IterModel(cfg), args.iter_ckpt,
                                   "itermodel", "iter", dev)
    loader = common.make_loader(cfg, args,
                                common.build_dataset(cfg, args, "test"),
                                batch_size=args.eval_batch_size)
    batch = common.to_device(next(iter(loader)), dev)
    options = dict(fine_geo=fine, hypotheses=hypotheses,
                   iter_iters=args.iter_iters, iter_shrink=args.iter_shrink,
                   hypo_score=args.hypo_score,
                   refine_rounds=args.refine_rounds,
                   refine_beam=tuple(args.refine_beam.split(",")),
                   beam_score=args.beam_score or None,
                   beam_frame=args.beam_frame)
    return (cfg, (geo, iter_model, agent),
            {k: batch[k] for k in serve.COMPOSED_KEYS}, options)


def export_labels(hypotheses) -> list:
    """The exporters of phase 19: one per ``EXPORT_PAIRS`` workload, and
    "composed" when ``hypotheses`` is given."""
    return [label for label, _ in EXPORT_PAIRS] + (
        ["composed"] if hypotheses else [])


def artifact_names(label: str, hypotheses) -> list:
    return ([f"composed_k{hypotheses}_bf16"] if label == "composed"
            else [f"geo_{label}", f"episode_{label}"])


def export_path(torch, serve, export, kitti_config, dev, label: str,
                hypotheses):
    """What the exporter ``label`` serves: ``(path label, [(artifact name,
    export call, traced body, inputs)], (eager, pairs a call, unit))``;
    an ``EXPORT_PAIRS`` label the geo forward and the episode of
    that workload (the episode's inputs from one eager geo forward),
    "composed" the composed pipeline at the E7 options on the trained
    weights (bf16 + int8) at ``hypotheses`` candidates."""
    if label == "composed":
        cfg, mods, inputs, opts = e7_composed(torch, dev, hypotheses)
        pipeline = serve.composed_pipeline(cfg, *mods, **opts)
        name, = artifact_names(label, hypotheses)
        return (name, [(name, lambda: export.export_composed_pipeline(
            cfg, *mods, inputs, **opts), pipeline, inputs)],
            (lambda: pipeline(inputs), 1, "requests"))
    cfg = kitti_config(**dict(EXPORT_PAIRS)[label])
    batch, model, agent, _ = serve.build_workload(cfg, B, seed=0)
    geo_body = export.geo_forward_body(model)
    ep_body = export.episode_body(cfg, agent)
    with torch.no_grad():
        state = geo_state(geo_body(batch), batch)

    def eager():
        with torch.no_grad():
            return ep_body(geo_state(geo_body(batch), batch))

    geo_name, ep_name = artifact_names(label, hypotheses)
    return (f"geo+episode[{label}]", [
        (geo_name, lambda: export.export_geo_forward(cfg, model, batch),
         geo_body, batch),
        (ep_name, lambda: export.export_episode(cfg, agent, state), ep_body,
         state)], (eager, B, "pairs"))


def hold_export(torch, kernels, name: str, made: dict, loaded, body,
                inputs):
    """``[export]``: the artifact's export and load seconds and bytes, its
    nodes and ``cmr::`` nodes, which must equal the launches of one eager
    run of the traced ``body`` on ``inputs``, no node of a plain version
    and no tensor made from host data. Returns the eager outputs."""
    from cmr_agent_tpu_torch.train import export
    nodes = export.kernel_nodes(loaded)
    kernels.reset_launch_counts()
    with torch.no_grad():
        want = body(inputs)
    torch.cuda.synchronize()
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    plain = loaded.meta["plain_nodes"]
    host = export.host_data_nodes(loaded)
    line("export", artifact=name, export_s=f"{made['export_s']:.2f}",
         bytes=made["bytes"], load_s=f"{made['load_s']:.2f}",
         nodes=len(loaded.program.graph.nodes), plain_nodes=plain,
         host_data_nodes=host, equal_to_eager_launches=nodes == launched,
         **{f"cmr_{k}": v for k, v in sorted(nodes.items())})
    assert nodes == launched, (name, nodes, launched)
    assert plain == 0 and host == 0, (name, plain, host)
    return want


def hold_twin(torch, name: str, loaded, inputs, want) -> dict:
    """``[export_twin]``: the loaded artifact captured (its graph pool: the
    memory the capture reserved) and replayed against the traced body's
    eager run on the same inputs: the same kernels in the same order, so
    the same bits. Returns the replay's outputs."""
    from torch.utils import _pytree
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    loaded.call(inputs)                                     # the capture
    torch.cuda.synchronize()
    pool = (torch.cuda.memory_reserved() - reserved) / 2 ** 30
    got = loaded.call(inputs)
    leaves = list(zip(_pytree.tree_leaves(got), _pytree.tree_leaves(want)))
    same = all(torch.equal(g, w) for g, w in leaves)
    diff = max((g.float() - w.float()).abs().max().item() for g, w in leaves)
    line("export_twin", artifact=name, same_bits=same, max_abs_diff=diff,
         graph_pool_gib=f"{pool:.3f}")
    assert same, (name, "replay differs from the traced body", diff)
    return got


def captured_turns(torch, label: str, eager, captured, uncaptured,
                   pairs: int, unit: str = "pairs", calls: int = 3) -> None:
    """``[captured]``: ``unit``/s (``pairs`` a call) of ``eager`` and
    ``captured`` in turns (eager, captured, captured, eager; ``calls``
    timed calls a turn), then of one ``uncaptured`` run of the loaded
    module (the export without the graph), each with its device time
    (``profile_device``) over its median call's wall time (the busy share;
    and over the profiled call's) and the peak memory allocated in the
    call (a captured call's graph pool is ``[export_twin]``'s)."""
    fns = {"eager": eager, "captured": captured, "uncaptured": uncaptured}
    rates = {k: [] for k in fns}
    for turn in ("eager", "captured", "captured", "eager", "uncaptured"):
        for _ in range(1 if turn == "uncaptured" else calls):
            rates[turn].append(pairs / timed(torch, fns[turn])[1])
    for kind, fn in fns.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rows, wall_ms = profile_device(fn)
        device_ms = sum(ms for ms, _ in rows.values())
        rate = statistics.median(rates[kind])
        line("captured", path=label, run=kind,
             **{f"{unit}_per_s": f"{rate:.3f}"},
             rates=",".join(f"{r:.3f}" for r in rates[kind]),
             device_ms=f"{device_ms:.3f}",
             device_busy_share=(f"{device_ms / (1e3 * pairs / rate):.3f}"
                                if device_ms else "not measured"),
             profiled_wall_ms=f"{wall_ms:.3f}",
             profiled_busy_share=(f"{device_ms / wall_ms:.3f}" if device_ms
                                  else "not measured"),
             peak_gib=f"{peak:.3f}")


def wait_for(path: str, timeout: float, proc=None) -> None:
    """Until the file ``path`` exists; raises if ``proc`` exits first or
    ``timeout`` seconds pass."""
    import os
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"process exited ({proc.returncode}) before "
                               f"{path}")
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout:.0f} s")
        time.sleep(0.5)


def export_worker(torch, kernels, serve, kitti_config, dev, label: str,
                  hypotheses) -> None:
    """Phase 19 for the exporter ``label`` (``export_path``), in a process
    of its own (``--export-worker``): it exports each artifact to
    ``EXPORT_DIR`` and loads it back while the other exporters and the
    fresh process do the same (untimed work; no kernel runs in a trace or
    a load), then writes ``<label>.ready`` and waits for ``<label>.go``,
    which phase 19 gives each exporter in turn; then, alone on the card
    and the host, per artifact ``[export]`` and ``[export_twin]``,
    ``[captured]``, and the first artifact replayed after the second was
    captured (its kernels' scratch is its own, ``[export_replay]``); each
    artifact's inputs and replay go to ``EXPORT_DIR`` for the fresh
    process."""
    import os
    from torch.utils import _pytree
    from cmr_agent_tpu_torch.train import export
    path_label, artifacts, (eager, pairs, unit) = export_path(
        torch, serve, export, kitti_config, dev, label, hypotheses)
    made, loaded = {}, {}
    for name, export_call, _, _ in artifacts:
        path = os.path.join(EXPORT_DIR, name)
        t0 = time.perf_counter()
        blob = export_call()
        export_s = time.perf_counter() - t0
        with open(path + ".part", "wb") as f:
            f.write(blob)
        os.replace(path + ".part", path + ".pt2")   # whole for the loader
        t0 = time.perf_counter()
        loaded[name] = export.load_exported(path + ".pt2")
        made[name] = dict(export_s=export_s, bytes=len(blob),
                          load_s=time.perf_counter() - t0)
        del blob
    with open(os.path.join(EXPORT_DIR, f"{label}.ready"), "w"):
        pass
    wait_for(os.path.join(EXPORT_DIR, f"{label}.go"), 3600)
    replays = []
    for name, _, body, inputs in artifacts:
        want = hold_export(torch, kernels, name, made[name], loaded[name],
                           body, inputs)
        got = hold_twin(torch, name, loaded[name], inputs, want)
        replays.append((name, inputs, got))
    # the path's artifacts in turn (geo forward, then episode)
    progs = [loaded[name] for name, _, _, _ in artifacts]
    x = artifacts[0][3]

    def through(call):
        if len(progs) == 1:
            return call(progs[0], x)
        return call(progs[1], geo_state(call(progs[0], x), x))

    captured_turns(torch, path_label, eager,
                   lambda: through(export.LoadedProgram.call),
                   lambda: through(export.LoadedProgram.run), pairs, unit,
                   calls=3 if unit == "pairs" else 1)
    if len(replays) > 1:
        name, inputs, first_out = replays[0]
        again = loaded[name].call(inputs)
        same = all(torch.equal(a, b) for a, b in zip(
            _pytree.tree_leaves(again), _pytree.tree_leaves(first_out)))
        line("export_replay", artifact=name,
             captured_after=len(replays) - 1, same_bits=same)
        assert same, "a later capture changed the first artifact's replay"
    for name, inputs, out in replays:
        path = os.path.join(EXPORT_DIR, name)
        torch.save({k: v.cpu() for k, v in inputs.items()},
                   path + ".inputs.pt")
        torch.save(_pytree.tree_map(lambda t: t.cpu(), out),
                   path + ".outputs.pt")
    # the process's memory after its exports' captures: each capture's
    # warm-up keeps an eager scratch buffer for the stream it ran on
    torch.cuda.synchronize()
    scratch = list(kernels._SCRATCH.values())
    line("export_memory", label=label, artifacts=len(artifacts),
         reserved_gib=f"{torch.cuda.memory_reserved() / 2**30:.3f}",
         allocated_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}",
         scratch_buffers=len(scratch),
         scratch_mib=f"{sum(b.numel() for b in scratch) / 2**20:.1f}")


def stop(procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def run_export(torch, hypotheses=None) -> None:
    """Phase 19: the serving export (``train/export.py``) on the card. One
    exporter process per ``export_labels`` (see ``export_worker``) and a
    fresh process that imports ``torch`` and the port only start together
    and export and load side by side (untimed: ``[export_untimed]``). Then,
    with nothing else running, each exporter in turn times and checks its
    artifacts (its lines relayed here), and last the fresh process calls
    each artifact on the exporters' inputs against their replays
    (``[export_load]``)."""
    import os
    import shutil
    t_phase = time.perf_counter()
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    os.makedirs(EXPORT_DIR)
    here = os.path.dirname(os.path.abspath(__file__))
    labels = export_labels(hypotheses)
    names = [n for label in labels for n in artifact_names(label, hypotheses)]
    workers, procs = [], []
    try:
        for label in labels:
            log = os.path.join(EXPORT_DIR, f"worker_{label}.log")
            argv = [sys.executable, os.path.join(here, "chip_smoke.py"),
                    "--export-worker", label]
            if hypotheses:
                argv += ["--hypotheses", str(hypotheses)]
            with open(log, "w") as out:
                proc = subprocess.Popen(argv, cwd=here, stdout=out,
                                        stderr=subprocess.STDOUT)
            procs.append(proc)
            workers.append((label, proc, log))
        loader_log = os.path.join(EXPORT_DIR, "loader")
        with open(loader_log + ".out", "w") as out, \
                open(loader_log + ".err", "w") as err:
            loader = subprocess.Popen(
                [sys.executable, "-c", EXPORT_LOAD_SCRIPT, EXPORT_DIR,
                 *names], cwd=here, stdout=out, stderr=err)
        procs.append(loader)
        for label, proc, _ in workers:
            wait_for(os.path.join(EXPORT_DIR, f"{label}.ready"), 3600, proc)
        wait_for(os.path.join(EXPORT_DIR, "loaded"), 3600, loader)
        line("export_untimed", processes=len(procs),
             seconds=f"{time.perf_counter() - t_phase:.1f}")
        for label, proc, log in workers:
            with open(os.path.join(EXPORT_DIR, f"{label}.go"), "w"):
                pass
            rc = proc.wait(timeout=1800)
            text = open(log).read()
            for s in text.splitlines():
                if s.startswith("["):
                    print(s, flush=True)
            assert rc == 0, f"exporter {label} exited {rc}:\n{text[-3000:]}"
        with open(os.path.join(EXPORT_DIR, "go"), "w"):
            pass
        t0 = time.perf_counter()
        rc = loader.wait(timeout=1800)
    finally:
        stop(procs)
    out = open(loader_log + ".out").read()
    assert rc == 0, open(loader_log + ".err").read()[-3000:]
    rows = [json.loads(s) for s in out.splitlines() if s.startswith("{")]
    loads = {r["artifact"]: r["load_s"] for r in rows if "load_s" in r}
    calls = [r for r in rows if "first_call_s" in r]
    for row in calls:
        line("export_load", load_s=loads[row["artifact"]], **row)
        assert row["finite"] and row["same_bits"] and \
            row["replays_equal"], row
    again = next(r for r in rows if "first_after_later_captures" in r)
    line("export_load", **again)
    assert again["same_bits"], again
    foreign = rows[-1]["foreign_modules"]
    line("export_load", calls_s=f"{time.perf_counter() - t0:.1f}",
         artifacts=len(calls), foreign_modules=foreign)
    assert not foreign and len(calls) == len(names), rows
    line("export_phase", seconds=f"{time.perf_counter() - t_phase:.1f}")


# --------------------------------------------------------------------------
# phase 20: the training entry points
# --------------------------------------------------------------------------

# the training CLIs' data: 16 train scenes (2 batches an epoch), 8 val
TRAIN_CLI_ARGV = ("--dataset", "synthetic", "--synthetic-length", "16",
                  "--val-length", "8", "--batch-size", str(B),
                  "--num-workers", "4")
GEO_STEP_KERNELS = ("segment_softmax_attend", "gather_rows", "knn",
                    "segment_sum", "segment_softmax_attend_backward")
ITER_KEYS = ("img", "pc", "node", "pt2node", "K", "P", "R_amplitude",
             "T_amplitude", "label_R", "label_T_x", "label_T_z")


def run_cli(tag: str, main, argv):
    """A CLI's ``main(argv)`` with its stdout captured, then relayed line by
    line as ``[tag] ...``. Returns ``(main's result, its lines)``."""
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = main(list(argv))
    finally:
        lines = buf.getvalue().splitlines()
        for ln in lines:
            print(f"[{tag}] {ln}", flush=True)
    return out, lines


@contextlib.contextmanager
def recording(torch, kernels, module, *names, after=None):
    """Wrap the step factories ``names`` of a CLI module: each call of a
    function they make runs between two synchronisations with the launch
    counts set to 0 just before it. Yields ``{name: [(seconds, counts),
    ...]}``; the last call's function and arguments are kept under
    ``(name, "last")``, each call's start and end (``time.perf_counter``)
    under ``(name, "spans")``. ``after(name, n)`` runs after the n-th
    call."""
    calls = {n: [] for n in names}
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, make):
        def make_recorded(*a, **kw):
            fn = make(*a, **kw)

            def recorded(*args):
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                calls[name].append((t1 - t0, kernels.launch_counts()))
                calls.setdefault((name, "spans"), []).append((t0, t1))
                calls[(name, "last")] = (fn, args)
                if after is not None:
                    after(name, len(calls[name]))
                return out
            return recorded
        return make_recorded

    try:
        for n, make in saved.items():
            setattr(module, n, wrap(n, make))
        yield calls
    finally:
        for n, make in saved.items():
            setattr(module, n, make)


def device_busy(torch, fn) -> tuple:
    """``(device ms, wall ms)`` of one profiled call of ``fn``."""
    rows, wall_ms = profile_device(fn)
    return sum(ms for ms, _ in rows.values()), wall_ms


def ckpt_names(root: str) -> list:
    import os
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, dirs, _ in os.walk(root) for n in dirs
                  if os.path.isfile(os.path.join(d, n, "model")))


def run_geo_clis(torch, kernels, tmp: str) -> None:
    """``[train_geo_cli]``: ``cli.train_geo`` for 6 steps eager, then at
    ``--steps-per-dispatch 2`` (one captured CUDA graph, a stop file after
    its sixth call: one capture and 5 replays), then ``--resume`` from the
    stop file's checkpoint for 2 more steps; the median steps/s of the
    eager steps after the first and of the replays, peak memory, launches
    per step and the busy share of the eager step beside the graph's
    replay, all at the CLIs' TF32."""
    import glob
    import os
    from cmr_agent_tpu_torch.cli import train_geo as cli
    from cmr_agent_tpu_torch.cli.common import tf32_precision
    stop = os.path.join(tmp, "geo_stop")
    base = list(TRAIN_CLI_ARGV) + ["--logdir", os.path.join(tmp, "log")]
    stats, names = {}, {}

    def stop_after_sixth(name, n):
        if n == 6:
            open(stop, "w").close()

    for label, name, extra, after in (
            ("eager", "make_geo_train_step", ["--steps", "6"], None),
            ("graph", "make_geo_multi_step",
             ["--steps", "14", "--steps-per-dispatch", "2", "--stop-file",
              stop], stop_after_sixth)):
        ck = os.path.join(tmp, "geo_" + label)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recording(torch, kernels, cli, name, after=after) as rec:
            state, lines = run_cli("train_geo_cli", cli.main,
                                   base + ["--ckpt-dir", ck] + extra)
        wall = time.perf_counter() - t0
        names[label] = ckpt_names(ck)
        calls = rec[name]
        fn, args = rec[(name, "last")]
        assert any(ln.startswith("[val] step 0 loss") for ln in lines), lines
        if label == "eager":
            assert len(calls) == 6 and state.step == 6, (len(calls),
                                                        state.step)
            step_s = statistics.median(t for t, _ in calls[1:])
            per_step = calls[-1][1]
            assert all(per_step[k] > 0 for k in GEO_STEP_KERNELS), per_step
        else:
            # the first call warms up twice and captures once; a replay
            # calls no wrapper, so no later call counts a launch
            assert len(calls) == 6 and state.step == 12, (len(calls),
                                                         state.step)
            assert all(sum(c.values()) == 0 for _, c in calls[1:]), calls
            assert any("stop-file" in ln for ln in lines), lines
            step_s = statistics.median(t for t, _ in calls[1:]) / 2
            per_step = {k: v / 3 for k, v in calls[0][1].items()}
            assert all(per_step[k] > 0 for k in GEO_STEP_KERNELS), per_step
        with tf32_precision():
            device_ms, wall_ms = device_busy(torch, lambda: fn(*args))
        steps_per_call = 1 if label == "eager" else 2
        stats[label] = (device_ms / wall_ms, device_ms / steps_per_call)
        MEASURED[f"geo_{label}_steps_per_s"] = 1 / step_s
        line("train_geo_cli", mode=label, batch=B, tf32="on",
             steps_per_s_median=f"{1 / step_s:.4f}",
             timed_calls=len(calls) - 1, steps_per_call=steps_per_call,
             call_ms=",".join(f"{t * 1e3:.2f}" for t, _ in calls),
             first_call_s=f"{calls[0][0]:.3f}", run_s=f"{wall:.2f}",
             peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
             **{f"launches_{k}": (f"{v:g}") for k, v in per_step.items()
                if v})
        del state, fn, args, rec
    line("train_geo_busy", tf32="on",
         eager_busy_share=f"{stats['eager'][0]:.3f}",
         graph_busy_share=f"{stats['graph'][0]:.3f}",
         eager_device_ms_per_step=f"{stats['eager'][1]:.2f}",
         graph_device_ms_per_step=f"{stats['graph'][1]:.2f}")
    # saved on the step-0 validation only (it improves on inf), and by the
    # stop file
    assert [n.split("/")[-1] for n in names["eager"]] == ["epoch-0-step-0"]
    assert [n.split("/")[-1] for n in names["graph"]] == [
        "epoch-0-step-0", "stop-epoch-6-step-12"], names
    resume, = glob.glob(os.path.join(tmp, "geo_graph", "*",
                                     "stop-epoch-6-step-12"))
    with recording(torch, kernels, cli, "make_geo_train_step") as rec:
        state, lines = run_cli("train_geo_cli", cli.main, base + [
            "--ckpt-dir", os.path.join(tmp, "geo_resume"), "--steps", "14",
            "--resume", resume])
    assert any(ln.startswith(f"resumed from {resume} at step 12 (optimizer "
                             "state restored") for ln in lines), lines
    assert state.step == 14 and len(rec["make_geo_train_step"]) == 2
    line("train_geo_cli", mode="resume", resumed_at=12, final_step=state.step,
         checkpoints="|".join(names["eager"] + names["graph"]))


def check_geo_multi_twin(torch, serve, dev) -> None:
    """``[geo_multi_twin]``: ``make_geo_multi_step(S=2)`` on the card (one
    captured graph, replayed twice) against two eager steps on the same
    batches and generator state: the per-step losses within rtol 1e-5, the
    eval loss after within rtol 1e-3 (the JAX package's tolerances for
    this pair, tests/test_train.py:355-398); then the first eager step at
    TF32 under :func:`hold_tf32`."""
    from cmr_agent_tpu_torch.cli.common import tf32_precision
    from cmr_agent_tpu_torch.config import kitti_config
    from cmr_agent_tpu_torch.train import train_geo
    cfg = kitti_config()
    batches = [serve.synthetic_batch(cfg, B, dev, seed=s,
                                     keys=serve.TRAIN_KEYS) for s in (0, 1)]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    eager = train_geo.create_geo_state(cfg, dev, seed=0)
    graph = train_geo.create_geo_state(cfg, dev, seed=0)
    g_eager = torch.Generator(device=dev).manual_seed(7)
    g_graph = torch.Generator(device=dev).manual_seed(7)
    step = train_geo.make_geo_train_step(cfg)
    want = [step(eager, b, g_eager)["loss"].item() for b in batches]
    got = train_geo.make_geo_multi_step(cfg, 2)(graph, stacked,
                                                g_graph)["loss"].tolist()
    ev = train_geo.make_geo_eval_step(cfg)
    e_want = ev(eager, batches[0])["loss"].item()
    e_got = ev(graph, batches[0])["loss"].item()
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    e_rel = abs(e_got - e_want) / abs(e_want)
    pairs = list(zip(list(graph.model.parameters())
                     + list(graph.model.buffers()),
                     list(eager.model.parameters())
                     + list(eager.model.buffers())))
    line("geo_multi_twin", steps=2, loss_graph=",".join(f"{v:.7f}"
                                                       for v in got),
         loss_eager=",".join(f"{v:.7f}" for v in want),
         loss_rel_diff=",".join(f"{v:.2e}" for v in rel),
         eval_loss_graph=f"{e_got:.7f}", eval_loss_eager=f"{e_want:.7f}",
         eval_rel_diff=f"{e_rel:.2e}",
         generator_states_equal=torch.equal(g_eager.get_state(),
                                            g_graph.get_state()),
         params_bit_equal=all(torch.equal(a, b) for a, b in pairs),
         max_param_diff=max((a - b).abs().max().item() for a, b in pairs),
         optimizer_step=graph.step)
    assert max(rel) <= 1e-5 and e_rel <= 1e-3, (got, want, e_got, e_want)
    assert torch.equal(g_eager.get_state(), g_graph.get_state())
    tf32 = train_geo.create_geo_state(cfg, dev, seed=0)
    g_tf32 = torch.Generator(device=dev).manual_seed(7)
    with tf32_precision():
        loss_tf32 = step(tf32, batches[0], g_tf32)["loss"].item()
    hold_tf32(torch, "geo_train_step", loss_tf32, want[0])


def hold_tf32(torch, step: str, loss_tf32: float, loss_f32: float,
              logits=None, **extra) -> None:
    """``[tf32_twin]``: a train step at the training CLIs' TF32 against
    the same step in full f32 from the same weights and inputs. TF32 rounds
    each matmul and convolution input to 10 mantissa bits (a relative 2^-11
    = 4.9e-4); over the ~20 layers between the input and the loss those
    errors add to at most about 1e-2, the gate: the loss within rtol 1e-2,
    and ``logits`` (``(tf32, f32)``) within 1e-2 of the f32 logits' largest
    magnitude."""
    rel = abs(loss_tf32 - loss_f32) / abs(loss_f32)
    if logits is not None:
        got, want = logits
        scale = want.abs().max().item()
        extra["max_logit_diff_over_max_abs"] = (
            f"{(got - want).abs().max().item() / scale:.3e}")
    line("tf32_twin", step=step, loss_tf32=f"{loss_tf32:.7f}",
         loss_f32=f"{loss_f32:.7f}", loss_rel_diff=f"{rel:.3e}", **extra)
    assert rel <= 1e-2, (step, loss_tf32, loss_f32)
    if logits is not None:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-2 * scale)


def run_agent_clis(torch, kernels, tmp: str) -> None:
    """``[train_agent_cli]``: ``cli.train_agent --steps 4`` (one buffer
    flush of 32 PPO updates, validation on 8 scenes), then the same with
    ``--expert-beta-frac 0.5``: rollout and update ms, peak memory and the
    launches of a rollout, an update, a geo forward and a validation
    episode."""
    import os
    from cmr_agent_tpu_torch.cli import train_agent as cli
    names = ("make_rollout_fn", "make_ppo_update_step",
             "make_val_episode_fn", "make_geo_forward")
    for label, extra in (("on_policy", []),
                         ("expert_beta", ["--expert-beta-frac", "0.5"])):
        ck = os.path.join(tmp, "agent_" + label)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recording(torch, kernels, cli, *names) as rec:
            state, lines = run_cli("train_agent_cli", cli.main, list(
                TRAIN_CLI_ARGV) + ["--steps", "4", "--ckpt-dir", ck,
                                   "--logdir", os.path.join(tmp, "log")]
                + extra)
        wall = time.perf_counter() - t0
        ro, up = rec["make_rollout_fn"], rec["make_ppo_update_step"]
        val, geo = rec["make_val_episode_fn"], rec["make_geo_forward"]
        cfg = state.agent.cfg
        # one buffer flush: num_trajectory rollouts, then full minibatches
        n_up = cfg.num_trajectory * B * cfg.action_num // cfg.ppo_batch_size
        assert len(ro) == 4 and len(up) == n_up and state.step == n_up, (
            len(ro), len(up), state.step)
        assert any(ln.startswith("[val] step 0 RRE") for ln in lines), lines
        assert ro[-1][1]["segment_mean_count_image"] == cfg.action_num
        assert val[-1][1]["segment_mean_count_image_project"] == \
            cfg.action_num, val
        assert all(geo[-1][1][k] > 0 for k in SERVING_KERNELS[:3]), geo
        line("train_agent_cli", mode=label, batch=B,
             rollout_ms=",".join(f"{t * 1e3:.2f}" for t, _ in ro),
             update_ms_median=(
                 f"{statistics.median(t for t, _ in up) * 1e3:.3f}"),
             val_episode_ms=f"{val[-1][0] * 1e3:.2f}",
             run_s=f"{wall:.2f}",
             peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
             checkpoints="|".join(ckpt_names(ck)),
             **{f"rollout_{k}": v for k, v in ro[-1][1].items() if v},
             **{f"val_episode_{k}": v for k, v in val[-1][1].items() if v},
             **{f"geo_forward_{k}": v for k, v in geo[-1][1].items() if v})
        del state, rec


def run_iter_cli(torch, kernels, tmp: str, label: str) -> None:
    """``cli.train_iter --steps 3`` at B = 8, with ``--remat`` where
    ``label`` is "remat": step ms, peak memory, the validation line and the
    checkpoints (the step-0 improvement and the final one)."""
    import os
    from cmr_agent_tpu_torch.cli import train_iter as cli
    ck = os.path.join(tmp, "iter_" + label)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(torch, kernels, cli, "make_iter_train_step") as rec:
        state, lines = run_cli("train_iter_cli", cli.main, list(
            TRAIN_CLI_ARGV) + ["--steps", "3", "--ckpt-dir", ck,
                               "--logdir", os.path.join(tmp, "log")]
            + (["--remat"] if label == "remat" else []))
    wall = time.perf_counter() - t0
    calls = rec["make_iter_train_step"]
    assert len(calls) == 3 and state.step == 3, (len(calls), state.step)
    # one warp a step; remat warps again in the backward's recompute
    warps = 2 if label == "remat" else 1
    assert all(c[1]["segment_sum_shared"] == warps for c in calls), calls
    assert any(ln.startswith("[val] step 0 cv_loss") for ln in lines)
    names = ckpt_names(ck)
    # the step-0 validation improves on inf; the final save at the cap
    # (the third step is the second epoch's first: 2 batches an epoch)
    assert [n.split("/")[-1] for n in names] == [
        "epoch-0-step-0", "epoch-1-step-3"], names
    line("train_iter_cli", mode=label, batch=B, tf32="on",
         step_ms=",".join(f"{t * 1e3:.2f}" for t, _ in calls),
         run_s=f"{wall:.2f}",
         peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
         warp_launches_per_step=calls[-1][1]["segment_sum_shared"],
         checkpoints="|".join(names))


def run_iter_worker(torch) -> None:
    """``[train_iter_cli]`` without ``--remat``: :func:`run_iter_cli` in a
    process of its own (``--iter-cli-worker``), its lines relayed here. Its
    ~69 GiB peak wants the card to itself, so the whole run starts it
    before phase 1 and ``--phase train`` once before its repeats: after the
    other phases this process's allocator keeps segments that a few small
    live tensors pin (8.7 GiB reserved for 0.09 GiB allocated after
    ``empty_cache``)."""
    import gc
    import os
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    gc.collect()
    torch.cuda.empty_cache()
    line("train_iter_cli", mode="plain", parent_allocated_gib=(
        f"{torch.cuda.memory_allocated() / 2**30:.3f}"),
        parent_reserved_gib=f"{torch.cuda.memory_reserved() / 2**30:.3f}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_iter_") as tmp:
        log = os.path.join(tmp, "iter_worker.log")
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(here, "chip_smoke.py"),
                 "--iter-cli-worker", tmp], cwd=here, stdout=out,
                stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=600)
        finally:
            stop([proc])
        text = open(log).read()
    for s in text.splitlines():
        if s.startswith("[") or rc:
            print(s if s.startswith("[") else f"[train_iter_cli] {s}",
                  flush=True)
    assert rc == 0, f"the train_iter worker exited {rc}"


def check_iter_train_twin(torch, kernels, serve, dev) -> None:
    """``[iter_train_twin]``: one IterModel train-mode forward + backward
    at B = 8 under ``cost_volume_remat`` (the warp runs twice, the second
    time in the backward's recompute), the kernels' twin against the plain
    kernels' from the same weights and geo outputs: the loss and the
    logits within phase 9's rtol 2e-4, the tower's gradients under phase
    6's rule with the warp's rows (``pc_geo_feat``) as the nudged input.
    Then the kernels' twin at TF32 under :func:`hold_tf32`."""
    from cmr_agent_tpu_torch.cli.common import tf32_precision
    from cmr_agent_tpu_torch.config import kitti_config
    from cmr_agent_tpu_torch.train import train_geo, train_iter
    cfg = kitti_config(cost_volume_remat=True)
    batch = serve.synthetic_batch(cfg, B, dev, seed=0, keys=ITER_KEYS)
    geo = train_geo.create_geo_state(cfg, dev, seed=0).model
    st = train_iter.iter_model_state(
        train_geo.make_geo_forward(cfg)(geo, batch), batch)
    del geo

    def run(model, s):
        model.zero_grad(set_to_none=True)
        out = model(s, with_loss=True)
        out["cost_volume_loss"].backward()
        return (out["cost_volume_loss"].detach(),
                out["cost_volume_logits"].detach(),
                {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()})

    def fresh():
        return train_iter.create_iter_state(cfg, dev, seed=0).model.train()

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    loss_k, logits_k, grads_k = run(fresh(), st)
    warps = kernels.launch_counts()["segment_sum_shared"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert warps == 2, warps
    nudges = [1.0 + s * 2.0 ** -e for e in (23, 22) for s in (1.0, -1.0)]
    # the nudged input is the warp's rows: the points only pick each row's
    # pixel, so a last-bit nudge of them moves no gradient at all
    with plain_kernels(kernels):
        model = fresh()
        loss_p, logits_p, grads_p = run(model, st)
        nudged = [run(model, dict(st, pc_geo_feat=st["pc_geo_feat"] * f))[2]
                  for f in nudges]
    del model
    torch.testing.assert_close(logits_k, logits_p, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(loss_k, loss_p, rtol=2e-4, atol=0)
    hold_gradients("iter_train_twin", grads_k, grads_p, nudged,
                   batch=B, remat=True, warp_launches=warps,
                   peak_gib=f"{peak:.3f}",
                   loss_kernels=f"{loss_k.item():.7f}",
                   loss_plain=f"{loss_p.item():.7f}",
                   max_logit_diff=(logits_k - logits_p).abs().max().item())
    with tf32_precision():
        loss_t, logits_t, grads_t = run(fresh(), st)
    # reported, not held: a gradient that is zero but for rounding (a
    # convolution bias ahead of a BatchNorm) differs by its whole size
    grad_rel = sorted((grads_t[n] - g).abs().max().item()
                      / max(g.abs().max().item(), 1e-30)
                      for n, g in grads_k.items())
    hold_tf32(torch, "iter_train_step", loss_t.item(), loss_k.item(),
              (logits_t, logits_k), batch=B,
              grad_diff_over_max_abs_median=(
                  f"{statistics.median(grad_rel):.3e}"),
              grad_diff_over_max_abs_max=f"{grad_rel[-1]:.3e}")


def check_six_dof(torch, kernels, serve, dev) -> None:
    """``[six_dof]``: ``is_6_dof`` at KITTI width, B = 8: phase 7's gate on
    an ``expert_beta=1.0`` rollout and one update, and phase 4's on one eval
    episode, each against its plain-kernel twin."""
    from cmr_agent_tpu_torch.config import kitti_config
    from cmr_agent_tpu_torch.train import train_agent, train_geo
    cfg = kitti_config(is_6_dof=True)
    batch = serve.synthetic_batch(cfg, B, dev, seed=0, keys=serve.TRAIN_KEYS)
    geo = train_geo.create_geo_state(cfg, dev, seed=0).model.eval()
    geo_out = train_geo.make_geo_forward(cfg)(geo, batch)
    order = np.random.default_rng(cfg.seed).permutation(B * cfg.action_num)
    agent_train_twin(torch, kernels, cfg, geo_out, batch, dev, order,
                     "six_dof")
    agent = train_agent.create_agent_state(cfg, dev, seed=3).agent.eval()
    got = serve.serve_episode(geo, agent, cfg, batch)
    with plain_kernels(kernels):
        want = serve.serve_episode(geo, agent, cfg, batch)
    r, t = got["steps"][0]
    assert r.shape == (B, 3, cfg.num_steps) and t.shape == r.shape, r.shape
    steps, diff = compare_episodes(torch, got, want, 1e-3)
    line("six_dof", episode="eval", logit_shape=tuple(r.shape),
         steps_compared=steps, max_logit_diff=diff,
         final_pose_max_diff=(got["final_pose"] - want["final_pose"]
                              ).abs().max().item())


def check_obs3d_compact(torch, kernels, serve, dev) -> None:
    """``[obs3d_compact]``: a bf16 + int8 eval episode with
    ``obs3d_source="compact"`` in the nc and the cn layout, each against
    its plain-kernel twin (phase 4's bf16 gate), and the two layouts against
    each other; then the agent's device time on the compacted observation
    beside the full one's."""
    import dataclasses
    from cmr_agent_tpu_torch.config import kitti_config
    from cmr_agent_tpu_torch.env.environment import (
        compact_observation_state, init_poses, observation_from_pose)
    cfg = kitti_config(compute_dtype="bfloat16", obs3d_source="compact")
    batch, model, agent, _ = serve.build_workload(cfg, B, dev, seed=0)
    serve.centre_overlap_head_(model, batch)
    got = {}
    for layout in ("nc", "cn"):
        c = dataclasses.replace(cfg, obs3d_cn=layout == "cn")
        got[layout] = serve.serve_episode(model, agent, c, batch)
        with plain_kernels(kernels):
            want = serve.serve_episode(model, agent, c, batch)
        steps, diff = compare_episodes(torch, got[layout], want, 1e-2, 3e-2)
        line("obs3d_compact", layout=layout, vs="plain", steps_compared=steps,
             max_logit_diff=diff)
    steps, diff = compare_episodes(torch, got["cn"], got["nc"], 1e-2, 3e-2)
    same = sum(torch.equal(a.argmax(-1), b.argmax(-1))
               and torch.equal(c.argmax(-1), d.argmax(-1))
               for (a, c), (b, d) in zip(got["cn"]["steps"],
                                         got["nc"]["steps"]))
    with torch.inference_mode():
        out = model(batch)
        state = compact_observation_state(
            {"pc": out["pc"], "K": batch["K"],
             "pc_overlap_pred": out["pc_overlap_pred"],
             "pc_geo_feat": out["pc_geo_feat"],
             "img_geo_feat": out["img_geo_feat"]}, cfg.raster_topk)
        pose = init_poses(batch)[0]
        obs = {src: observation_from_pose(
            state, pose, cfg.image_h, cfg.image_w, torch.int8, "mega",
            obs3d_compact=src == "compact") for src in ("compact", "full")}
        assert obs["compact"][1].shape == (B, cfg.raster_topk, 5)
        agent_ms = {src: device_busy(torch, lambda: agent(*o))[0]
                    for src, o in obs.items()}
    line("obs3d_compact", layout="cn_vs_nc", steps_compared=steps,
         steps_with_equal_actions=f"{same}/{len(got['nc']['steps'])}",
         max_logit_diff=diff, rows=cfg.raster_topk,
         overlap_rows=state["raster_valid"].sum(1).tolist(),
         agent_device_ms_compact=f"{agent_ms['compact']:.3f}",
         agent_device_ms_full=f"{agent_ms['full']:.3f}")


def run_train(torch, kernels, serve, dev) -> None:
    """Phase 20 after :func:`run_iter_worker`, which its callers run first:
    the training entry points (see the module docstring); the CLIs at their
    own TF32, the twins in full f32."""
    import gc
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        for name, fn in (
                ("train_iter_cli_remat", lambda: run_iter_cli(
                    torch, kernels, tmp, "remat")),
                ("train_geo_cli", lambda: run_geo_clis(torch, kernels, tmp)),
                ("geo_multi_twin", lambda: check_geo_multi_twin(torch, serve,
                                                               dev)),
                ("train_agent_cli", lambda: run_agent_clis(torch, kernels,
                                                           tmp)),
                ("iter_train_twin", lambda: check_iter_train_twin(
                    torch, kernels, serve, dev)),
                ("six_dof", lambda: check_six_dof(torch, kernels, serve,
                                                  dev)),
                ("obs3d_compact", lambda: check_obs3d_compact(
                    torch, kernels, serve, dev))):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            line("train_part", name=name,
                 seconds=f"{time.perf_counter() - t0:.1f}",
                 allocated_gib_after=(
                     f"{torch.cuda.memory_allocated() / 2**30:.3f}"))


# ---- phase 21: the reference's own inputs ---------------------------------

KITTI_CALIB_TXT = (
    "P0: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 "
    "0.000000000000e+00 0.000000000000e+00 7.188560000000e+02 "
    "1.852157000000e+02 0.000000000000e+00 0.000000000000e+00 "
    "0.000000000000e+00 1.000000000000e+00 0.000000000000e+00\n"
    "P1: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 "
    "-3.861448000000e+02 0.000000000000e+00 7.188560000000e+02 "
    "1.852157000000e+02 0.000000000000e+00 0.000000000000e+00 "
    "0.000000000000e+00 1.000000000000e+00 0.000000000000e+00\n"
    "P2: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 "
    "4.538225000000e+01 0.000000000000e+00 7.188560000000e+02 "
    "1.852157000000e+02 -1.130887000000e-01 0.000000000000e+00 "
    "0.000000000000e+00 1.000000000000e+00 3.779761000000e-03\n"
    "P3: 7.188560000000e+02 0.000000000000e+00 6.071928000000e+02 "
    "-3.372877000000e+02 0.000000000000e+00 7.188560000000e+02 "
    "1.852157000000e+02 2.369057000000e+00 0.000000000000e+00 "
    "0.000000000000e+00 1.000000000000e+00 4.915215000000e-03\n"
    "Tr: 4.276802385584e-04 -9.999672484946e-01 -8.084491683471e-03 "
    "-1.198459927713e-02 -7.210626507497e-03 8.081198471645e-03 "
    "-9.999413164504e-01 -5.403984729748e-02 9.999738645903e-01 "
    "4.859485810390e-04 -7.206933692422e-03 -2.921968648686e-01\n")
KITTI_TREE = dict(seqs=("00", "09", "10"), frames=8, h=376, w=1241,
                  n_pts=120000)
NUSCENES_TREE = dict(count=16, n_pts=34720, h=160, w=320)
# sha256 of the first 8 test samples of each tree (seed 0) as
# ``cli.common.build_dataset`` builds them (native host ops); held by
# tests/test_torch_data.py on the CPU
INPUTS_SPLIT_SHA256 = {
    "kitti": "b57bec5e6ea446422f9a5f0143fbca352f14f28e1319a0730bb5bafb09cb400b",
    "nuscenes":
        "ccce6e6be3265fec04f4dcbab3a82902ccdbb3af28d01e2dae6fcc0b7e25db7d"}
INPUTS_SPLIT_N = 8


def write_kitti_tree(root: str, seed: int = 0, seqs=KITTI_TREE["seqs"],
                     frames: int = KITTI_TREE["frames"],
                     h: int = KITTI_TREE["h"], w: int = KITTI_TREE["w"],
                     n_pts: int = KITTI_TREE["n_pts"],
                     data_color: str = "data_odometry_color_npy/",
                     data_velodyne: str = "data_odometry_velodyne_NWU/"):
    """A KITTI odometry dump in the reference's layout: ``calib/<seq>/
    calib.txt`` (sequence 00's real numbers), uint8 ``image_2`` /
    ``image_3`` frames and ``[4, n_pts]`` f32 velodyne dumps (x forward,
    the points in a cone ahead of the sensor, intensity in row 3). Each
    file is drawn from its own generator, so a tree cut to fewer
    sequences or frames holds the same files."""
    import os
    for seq in seqs:
        cdir = os.path.join(root, "calib", seq)
        os.makedirs(cdir, exist_ok=True)
        with open(os.path.join(cdir, "calib.txt"), "w") as f:
            f.write(KITTI_CALIB_TXT)
        vdir = os.path.join(root, data_velodyne, "sequences/", seq,
                            "voxel0.1-SNr0.6")
        os.makedirs(vdir, exist_ok=True)
        for cam in (2, 3):
            os.makedirs(os.path.join(root, data_color, "sequences/", seq,
                                     f"image_{cam}"), exist_ok=True)
        for frame in range(frames):
            for cam in (2, 3):
                rng = np.random.default_rng((seed, int(seq), frame, cam))
                img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                np.save(os.path.join(root, data_color, "sequences/", seq,
                                     f"image_{cam}", "%06d.npy" % frame), img)
            rng = np.random.default_rng((seed, int(seq), frame, 0))
            x = rng.uniform(2.0, 60.0, n_pts)
            pc = np.stack([x, rng.uniform(-0.8, 0.8, n_pts) * x,
                           rng.uniform(-2.0, 2.0, n_pts),
                           rng.uniform(0.0, 1.0, n_pts)])
            np.save(os.path.join(vdir, "%06d.npy" % frame),
                    pc.astype(np.float32))


def write_nuscenes_tree(root: str, seed: int = 0,
                        count: int = NUSCENES_TREE["count"],
                        n_pts: int = NUSCENES_TREE["n_pts"],
                        h: int = NUSCENES_TREE["h"],
                        w: int = NUSCENES_TREE["w"], subs=("train", "test")):
    """A nuScenes pre-dump in the reference's layout: ``<sub>/{PC,img,K}/
    %06d.npy`` triplets of a ``[4, n_pts]`` f32 cloud in the camera frame
    (z forward, intensity in row 3), an ``h x w`` uint8 image and its K.
    Each triplet is drawn from its own generator."""
    import os
    for sub in subs:
        for d in ("PC", "img", "K"):
            os.makedirs(os.path.join(root, sub, d), exist_ok=True)
        for i in range(count):
            rng = np.random.default_rng((seed, ("train", "test").index(sub),
                                         i))
            z = rng.uniform(2.0, 50.0, n_pts)
            pc = np.stack([rng.uniform(-0.8, 0.8, n_pts) * z,
                           rng.uniform(-0.3, 0.3, n_pts) * z, z,
                           rng.uniform(0.0, 100.0, n_pts)])
            np.save(os.path.join(root, sub, "PC", "%06d.npy" % i),
                    pc.astype(np.float32))
            np.save(os.path.join(root, sub, "img", "%06d.npy" % i),
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            K = np.array([[253.2, 0.0, w / 2], [0.0, 253.2, h / 2],
                          [0.0, 0.0, 1.0]])
            np.save(os.path.join(root, sub, "K", "%06d.npy" % i), K)


FEED_SAMPLES = 200


def link_train_split(root: str, name: str) -> None:
    """Lengthen a tree's train split to :data:`FEED_SAMPLES` samples with
    symbolic links to the files it has (KITTI sequence 00's frames,
    nuScenes' train triplets), so that an epoch outlasts the feed
    measurement and the training runs: each sample still draws its own
    crop, downsample, jitter and perturbation from its index."""
    import os
    if name == "kitti":
        seq = KITTI_TREE["seqs"][0]
        dirs = [os.path.join(root, "data_odometry_color_npy/", "sequences/",
                             seq, f"image_{c}") for c in (2, 3)]
        dirs.append(os.path.join(root, "data_odometry_velodyne_NWU/",
                                 "sequences/", seq, "voxel0.1-SNr0.6"))
        want = FEED_SAMPLES // 2
    else:
        dirs = [os.path.join(root, "train", d) for d in ("PC", "img", "K")]
        want = FEED_SAMPLES
    have = len(os.listdir(dirs[0]))
    for d in dirs:
        for i in range(have, want):
            os.symlink("%06d.npy" % (i % have), os.path.join(d, "%06d.npy" % i))


def samples_sha256(samples) -> str:
    """sha256 over each sample's keys in sorted order: name, dtype, shape
    and bytes of every array."""
    import hashlib
    h = hashlib.sha256()
    for s in samples:
        for k in sorted(s):
            a = np.ascontiguousarray(np.asarray(s[k]))
            h.update(f"{k}|{a.dtype.str}|{a.shape}|".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def dataset_argv(name: str, root: str) -> list:
    return ["--dataset", name, "--data-root", root]


def inputs_split_digests(roots: dict) -> dict:
    """``{dataset: sha256}`` of the first :data:`INPUTS_SPLIT_N` test
    samples of each tree in ``roots`` as the CLIs' ``build_dataset``
    builds them."""
    import argparse
    from cmr_agent_tpu_torch.cli import common
    out = {}
    for name, root in roots.items():
        args = common.add_common_args(argparse.ArgumentParser()).parse_args(
            dataset_argv(name, root))
        ds = common.build_dataset(common.build_config(args), args, "test")
        out[name] = samples_sha256(ds[i] for i in range(INPUTS_SPLIT_N))
    return out


# the reference's pointwise stacks are Conv1d (weights [O, I, 1]); its
# attention and head MLPs are Linear
CONV1D_PARTS = (".layer_", ".net.", ".shortcut.", "_fuse_convs.",
                "pc_overlap_head.", "pc_geo_head.", "state_3d_embed.")
IMAGE_EMBEDDINGS = "encoder_decoder.encoder.img_transformer.embeddings."


def reference_state_dict(torch, state_dict, which: str) -> dict:
    """A port ``state_dict`` in the reference's ``.pth`` layout: pointwise
    weights as ``Conv1d [O, I, 1]``, the IterModel tower's as ``Conv3d
    [O, I, 1, kh, kw]``, a ``num_batches_tracked`` beside each BatchNorm,
    and for the geo model the image ``Embeddings``' alias keys
    (``embedding_layers.0`` the MiniResNet, ``.1`` the patchify conv) and
    its ``position_embeddings``."""
    out = {}
    for k, v in state_dict.items():
        v = v.detach().cpu().clone()
        if which == "itermodel" and v.ndim == 4:
            v = v[:, :, None]
        elif (k.endswith(".weight") and v.ndim == 2
              and any(p in k for p in CONV1D_PARTS)):
            v = v[:, :, None]
        out[k] = v
        if k.endswith(".running_var"):
            out[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(1000, dtype=torch.long)
    if which == "multihead":
        for k in list(out):
            for j, part in enumerate(("mini_resnet.", "patch_embeddings.")):
                if k.startswith(IMAGE_EMBEDDINGS + part):
                    rest = k[len(IMAGE_EMBEDDINGS + part):]
                    out[f"{IMAGE_EMBEDDINGS}embedding_layers.{j}.{rest}"] = \
                        out[k].clone()
        out[IMAGE_EMBEDDINGS + "position_embeddings"] = torch.zeros(1, 80, 64)
    return out


# numbers an earlier phase measured in this process, for a later one to
# print beside its own
MEASURED = {}
INPUT_KITTI_STEPS, INPUT_NUSC_STEPS = 6, 3


def inputs_cli_argv(name: str, root: str, tmp: str, dev, *extra) -> list:
    import os
    return dataset_argv(name, root) + [
        "--device", str(dev), "--logdir", os.path.join(tmp, "log"),
        "--ckpt-dir", os.path.join(tmp, "ckpt_" + name)] + list(extra)


def check_inputs_split(roots: dict) -> None:
    """``[inputs_split]``: the first 8 test samples of each tree, built on
    this host as the CLIs build them, against the digests the CPU tests
    hold (``tests/test_torch_data.py``)."""
    t0 = time.perf_counter()
    got = inputs_split_digests(roots)
    for name, digest in got.items():
        line("inputs_split", dataset=name, samples=INPUTS_SPLIT_N,
             sha256=digest,
             equal_to_the_cpu_digest=digest == INPUTS_SPLIT_SHA256[name],
             seconds=f"{time.perf_counter() - t0:.2f}")
    assert got == INPUTS_SPLIT_SHA256, got


def check_inputs_feed(roots: dict) -> None:
    """``[inputs_feed]``: ``data.smoke --feed-rate 20`` on each tree's train
    split (lengthened, :func:`link_train_split`) through the training CLIs'
    loader (its default workers, a process pool), beside the captured geo
    step's samples/s (null, and no verdict, where phase 20 did not run in
    this process). The smoke's figure times the 20 batches after a
    warm-up batch, and the batches the pool finished during the warm-up
    (up to its window of tasks in flight) count in it; the steady rate
    takes the batches after that window, from each batch's arrival."""
    import os
    from cmr_agent_tpu_torch.cli import common
    from cmr_agent_tpu_torch.data import smoke
    graph = MEASURED.get("geo_graph_steps_per_s")
    make = common.make_loader
    for name in ("kitti", "nuscenes"):
        arrivals, window = [], []

        class Timed:
            """The CLIs' loader, noting when each batch arrives."""

            def __init__(self, loader):
                self.loader = loader
                window.append(max(loader.prefetch, loader.num_workers))

            def __getattr__(self, attr):
                return getattr(self.loader, attr)

            def __len__(self):
                return len(self.loader)

            def __iter__(self):
                for batch in self.loader:
                    arrivals.append(time.perf_counter())
                    yield batch

        common.make_loader = lambda *a, **k: Timed(make(*a, **k))
        try:
            rate, lines = run_cli("inputs_feed_cli", smoke.main, dataset_argv(
                name, roots[name]) + ["--feed-rate", "20"])
        finally:
            common.make_loader = make
        loader = next(ln for ln in lines if ln.startswith("loader:"))
        timed_line = next(ln for ln in lines if ln.startswith("feed rate"))
        steady = arrivals[window[0] + 1:]
        steady_rate = (B * (len(steady) - 1) / (steady[-1] - steady[0])
                       if len(steady) > 1 else float("nan"))
        line("inputs_feed", dataset=name, split="train", batch=B,
             samples_per_s=f"{rate:.2f}", timed=repr(timed_line),
             steady_samples_per_s=f"{steady_rate:.2f}",
             steady_batches=len(steady) - 1, loader=repr(loader),
             host_cores=os.cpu_count(),
             geo_graph_samples_per_s=(f"{graph * B:.2f}" if graph
                                      else "null"),
             steady_feeds_the_graph=(steady_rate >= graph * B if graph
                                     else "null"))
        assert rate > 0 and len(steady) > 1, (lines, len(arrivals))


def run_inputs_train_geo(torch, kernels, roots: dict, tmp: str, dev,
                         name: str) -> None:
    """``[train_geo_<name>]``: ``cli.train_geo`` on the tree for 6 (KITTI)
    or 3 (nuScenes) eager steps at B = 8, the CLIs' TF32: steps/s, busy
    share, peak memory, launches per step and the host's time between two
    steps (the loader's wait, the batch's copy, logging); on nuScenes then
    phase 6's gate on a batch of the tree (phase 6 holds KITTI's width)."""
    from cmr_agent_tpu_torch.cli import train_geo as cli
    from cmr_agent_tpu_torch.cli.common import tf32_precision, to_device
    steps = INPUT_KITTI_STEPS if name == "kitti" else INPUT_NUSC_STEPS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(torch, kernels, cli, "make_geo_train_step") as rec:
        state, lines = run_cli(f"train_geo_{name}_cli", cli.main,
                               inputs_cli_argv(name, roots[name], tmp, dev,
                                               "--steps", str(steps)))
    wall = time.perf_counter() - t0
    calls = rec["make_geo_train_step"]
    spans = rec[("make_geo_train_step", "spans")]
    fn, args = rec[("make_geo_train_step", "last")]
    assert any(ln.startswith("[val] step 0 loss") for ln in lines), lines
    assert len(calls) == steps and state.step == steps, (len(calls),
                                                         state.step)
    per_step = calls[-1][1]
    assert all(per_step[k] > 0 for k in GEO_STEP_KERNELS), per_step
    step_s = statistics.median(t for t, _ in calls[1:])
    gaps = [b[0] - a[1] for a, b in zip(spans[1:], spans[2:])]
    with tf32_precision():
        device_ms, wall_ms = device_busy(torch, lambda: fn(*args))
    batch = args[1]
    cfg = common_config(name, roots[name])
    line(f"train_geo_{name}", batch=B, tf32="on", steps=steps,
         width=f"{cfg.image_h}x{cfg.image_w}",
         steps_per_s_median=f"{1 / step_s:.4f}",
         step_ms=",".join(f"{t * 1e3:.2f}" for t, _ in calls),
         host_ms_between_steps=",".join(f"{g * 1e3:.2f}" for g in gaps),
         host_ms_between_steps_median=(
             f"{statistics.median(gaps) * 1e3:.2f}" if gaps else "none"),
         busy_share=f"{device_ms / wall_ms:.3f}",
         device_ms_per_step=f"{device_ms:.2f}", run_s=f"{wall:.2f}",
         peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
         **{f"launches_{k}": v for k, v in per_step.items() if v})
    del state, fn, args, rec
    if name == "nuscenes":
        # the KITTI width's step is held by phase 6; this is the new one
        compare_geo_twins(torch, kernels, cfg, batch, dev)


def common_config(name: str, root: str, **over):
    """The CLIs' configuration of ``--dataset name --data-root root``."""
    from cmr_agent_tpu_torch.config import kitti_config, nuscenes_config
    return (kitti_config if name == "kitti" else nuscenes_config)(root,
                                                                  **over)


def tree_batch(torch, cfg, mode: str, dev) -> dict:
    """The first ``B`` samples of the ``mode`` split of ``cfg``'s tree,
    collated and on ``dev`` (the CLIs' dataset and host ops)."""
    import argparse
    from cmr_agent_tpu_torch.cli import common
    from cmr_agent_tpu_torch.data import collate
    args = argparse.Namespace(dataset=cfg.name, tiny=False)
    ds = common.build_dataset(cfg, args, mode)
    return common.to_device(collate([ds[i] for i in range(B)]), dev)


def run_nuscenes_serve(torch, kernels, serve, roots: dict, dev) -> None:
    """``[nuscenes_serve]``: phase 4's serving path (geo forward + 10-step
    episode, B = 8) at ``nuscenes_config`` width on the nuScenes test
    split, f32 and bf16 + int8, against its plain twin under phase 4's
    gates; then ``cli.test_geo --dataset nuscenes --max-batches 1`` at the
    committed weights with its launches, and one IterModel forward on a
    B = 8 batch of the split against its plain twin (phase 9's gate)."""
    import argparse
    from cmr_agent_tpu_torch.cli import common, test_geo
    from cmr_agent_tpu_torch.models.cost_volume import IterModel
    from cmr_agent_tpu_torch.train.train_iter import iter_model_state
    root = roots["nuscenes"]
    for dtype in ("float32", "bfloat16"):
        cfg = common_config("nuscenes", root, compute_dtype=dtype)
        batch = {k: v for k, v in tree_batch(torch, cfg, "test", dev).items()
                 if k in serve.BATCH_KEYS}
        counts, rate = run_path(torch, kernels, serve,
                                lambda **kw: common_config("nuscenes", root,
                                                           **kw),
                                dtype, batch=batch, profile=False)
        line("nuscenes_serve", dtype=dtype, width=f"{cfg.image_h}x"
             f"{cfg.image_w}", pairs_per_s=f"{rate:.3f}",
             **{f"launches_{k}": v for k, v in counts.items() if v})
    argv = (dataset_argv("nuscenes", root)
            + ["--device", str(dev), "--max-batches", "1", "--geo-ckpt",
               "runs_r4/geo_pi", "--iter-ckpt",
               "checkpoint/iter_kitti/epoch-1-step-10000", "--unmasked-warp"])
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out, _ = run_cli("nuscenes_test_geo_cli", test_geo.main, argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    line("nuscenes_test_geo", seconds=f"{time.perf_counter() - t0:.2f}",
         num_samples=out["num_samples"],
         **{f"launches_{k}": v for k, v in counts.items() if v})
    assert out["num_samples"] == 1 and counts["segment_sum_shared"] > 0, (
        out, counts)
    assert all(np.isfinite(v) for v in out.values()), out
    cfg = common_config("nuscenes", root, cost_volume_unmasked=True)
    geo = common.load_geo_variables(
        cfg, argparse.Namespace(geo_ckpt="runs_r4/geo_pi"), dev)
    iter_model = common.load_model(
        cfg, IterModel(cfg), "checkpoint/iter_kitti/epoch-1-step-10000",
        "itermodel", "iter", dev)
    batch = tree_batch(torch, cfg, "test", dev)
    with torch.no_grad():
        st = iter_model_state(geo(batch), batch)
        kernels.reset_launch_counts()
        got, t = timed(torch, lambda: iter_model(st, with_loss=False))
        counts = kernels.launch_counts()
        with plain_kernels(kernels):
            want = iter_model(st, with_loss=False)
    logits, wl = got["cost_volume_logits"], want["cost_volume_logits"]
    diff = (logits - wl).abs().max().item()
    line("nuscenes_itermodel_vs_plain", batch=B, forward_ms=f"{t * 1e3:.2f}",
         launches_segment_sum_shared=counts["segment_sum_shared"],
         max_logit_diff=diff, logit_absmax=wl.abs().max().item())
    assert counts["segment_sum_shared"] > 0, counts
    torch.testing.assert_close(logits, wl, rtol=2e-4, atol=2e-5)


def write_reference_pths(torch, tmp: str) -> dict:
    """The committed weight exports of E7 as reference-layout ``.pth``
    files: ``{orbax path: .pth path}``, with the state each export loads
    into its module (the reference the import is held to)."""
    import os
    from cmr_agent_tpu_torch.config import kitti_config
    from cmr_agent_tpu_torch.models.agent import CMRAgent
    from cmr_agent_tpu_torch.models.cost_volume import IterModel
    from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
    from cmr_agent_tpu_torch.train import checkpoint
    cfg = kitti_config(**FLAGSHIP_CFG)
    make = {"multihead": MultiHeadModel, "agent": CMRAgent,
            "itermodel": IterModel}
    out = {}
    for stem, entry in sorted(checkpoint.manifest().items()):
        which = ("agent" if stem.startswith("agent") else "itermodel"
                 if stem.startswith("iter") else "multihead")
        module = checkpoint.load_module_variables(
            make[which](cfg), cfg, checkpoint.restore_model_variables(
                str(checkpoint.WEIGHTS_DIR / entry["file"])), which)
        path = os.path.join(tmp, stem + ".pth")
        torch.save(reference_state_dict(torch, module.state_dict(), which),
                   path)
        out[entry["orbax"]] = (path, which, module.state_dict())
    return out


def check_pth_import(torch, pths: dict, dev) -> None:
    """``[pth_import]``: each reference ``.pth`` loaded through the CLIs'
    loader (``cli.common.load_model``, behind every checkpoint flag) equals
    its weight export's load, tensor for tensor, bit for bit."""
    import os
    from cmr_agent_tpu_torch.cli import common
    from cmr_agent_tpu_torch.config import kitti_config
    from cmr_agent_tpu_torch.models.agent import CMRAgent
    from cmr_agent_tpu_torch.models.cost_volume import IterModel
    from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
    cfg = kitti_config(**FLAGSHIP_CFG)
    make = {"multihead": MultiHeadModel, "agent": CMRAgent,
            "itermodel": IterModel}
    for orbax, (path, which, want) in pths.items():
        t0 = time.perf_counter()
        got = common.load_model(cfg, make[which](cfg), path, which, which,
                                dev).state_dict()
        torch.cuda.synchronize()
        same = got.keys() == want.keys() and all(
            torch.equal(v.cpu(), want[k]) for k, v in got.items())
        line("pth_import", pth=os.path.basename(path), replaces=orbax,
             which=which, tensors=len(got), bytes=os.path.getsize(path),
             load_s=f"{time.perf_counter() - t0:.3f}", bit_equal=same)
        assert same, path


def run_eval_kitti(torch, kernels, roots: dict, pths: dict, dev) -> None:
    """``[eval_kitti]``: ``cli.test_agent --dataset kitti --max-batches 1``
    at E7's flags in bf16, every checkpoint flag given its reference
    ``.pth``: launches and s/pair (random scenes: no accuracy claim)."""
    from cmr_agent_tpu_torch.cli import test_agent
    argv = e7_argv(dev)
    i = argv.index("--dataset")
    argv[i:i + 2] = dataset_argv("kitti", roots["kitti"])
    for flag in ("--geo-ckpt", "--fine-geo-ckpt", "--agent-ckpt",
                 "--iter-ckpt"):
        j = argv.index(flag)
        argv[j + 1] = pths[argv[j + 1]][0]
    argv += ["--max-batches", "1"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out, lines = run_cli("eval_kitti_cli", test_agent.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    assert sum("from" in ln and ".pth" in ln for ln in lines) == 4, lines
    line("eval_kitti", dtype="bfloat16", pairs=out["num_samples"],
         run_s=f"{wall:.2f}", s_per_pair=f"{wall / out['num_samples']:.3f}",
         registration_recall=out["registration_recall"],
         **{f"launches_{k}": v for k, v in counts.items() if v})
    assert out["num_samples"] == B, out
    assert all(counts[k] > 0 for k in EVAL_KERNELS), counts


def run_gnn_geo(torch, kernels, roots: dict, dev) -> None:
    """``[gnn_geo]``: the geo train step with ``use_gnn_embedding`` at KITTI
    width, B = 8, f32, on a batch of the KITTI tree with its host knn
    (``pc_knn``, k = 16): launches, peak memory, steps/s; then phase 6's
    gate (gradients and three losses against the plain twin)."""
    from cmr_agent_tpu_torch.train import train_geo
    cfg = common_config("kitti", roots["kitti"], use_gnn_embedding=True)
    t0 = time.perf_counter()
    batch = tree_batch(torch, cfg, "train", dev)
    batch_s = time.perf_counter() - t0
    assert tuple(batch["pc_knn"].shape) == (B, N_PT, KNN_K)
    step = train_geo.make_geo_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = train_geo.create_geo_state(cfg, dev, seed=0)
    step(state, batch, gen)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    metrics, _ = timed(torch, lambda: step(state, batch, gen))
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    times = [timed(torch, lambda: step(state, batch, gen))[1]
             for _ in range(3)]
    assert all(torch.isfinite(v) for v in metrics.values()), metrics
    assert all(counts[k] > 0 for k in GEO_STEP_KERNELS), counts
    line("gnn_geo", batch=B, knn_k=cfg.knn_k, host_batch_s=f"{batch_s:.2f}",
         steps_per_s=f"{1 / statistics.median(times):.4f}",
         step_s=",".join(f"{t:.4f}" for t in times),
         peak_gib=f"{peak / 2**30:.3f}",
         gnn_params=sum(p.numel() for n, p in state.model.named_parameters()
                        if ".mini_gnn." in n or ".pos_embed_" in n),
         **{f"launches_{k}": v for k, v in counts.items() if v})
    del state, metrics
    torch.cuda.empty_cache()
    compare_geo_twins(torch, kernels, cfg, batch, dev)


def run_inputs(torch, kernels, serve, dev) -> None:
    """Phase 21: the reference's own inputs (see the module docstring)."""
    import gc
    import os
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_inputs_") as tmp:
        roots = {"kitti": os.path.join(tmp, "kitti"),
                 "nuscenes": os.path.join(tmp, "nuscenes")}
        t0 = time.perf_counter()
        write_kitti_tree(roots["kitti"])
        write_nuscenes_tree(roots["nuscenes"])
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(tmp) for f in fs)
        for name, root in roots.items():
            link_train_split(root, name)
        line("inputs_trees", bytes=size,
             seconds=f"{time.perf_counter() - t0:.2f}",
             kitti=repr(KITTI_TREE), nuscenes=repr(NUSCENES_TREE),
             train_samples_linked=FEED_SAMPLES)
        pths = {}
        for name, fn in (
                ("inputs_split", lambda: check_inputs_split(roots)),
                ("inputs_feed", lambda: check_inputs_feed(roots)),
                ("pth_import", lambda: (pths.update(
                    write_reference_pths(torch, tmp)),
                    check_pth_import(torch, pths, dev))),
                ("train_geo_kitti", lambda: run_inputs_train_geo(
                    torch, kernels, roots, tmp, dev, "kitti")),
                ("train_geo_nuscenes", lambda: run_inputs_train_geo(
                    torch, kernels, roots, tmp, dev, "nuscenes")),
                ("nuscenes_serve", lambda: run_nuscenes_serve(
                    torch, kernels, serve, roots, dev)),
                ("eval_kitti", lambda: run_eval_kitti(torch, kernels, roots,
                                                      pths, dev)),
                ("gnn_geo", lambda: run_gnn_geo(torch, kernels, roots,
                                                dev))):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            line("inputs_part", name=name,
                 seconds=f"{time.perf_counter() - t0:.1f}",
                 allocated_gib_after=(
                     f"{torch.cuda.memory_allocated() / 2**30:.3f}"))


# ---- phase 22: the last modules --------------------------------------------

# the SSG segmentation stack of PointNet++'s pointnet2_sem_seg (the code the
# reference's pointnet_util comes from): SA (npoint, radius, nsample,
# in_channel, mlp) and FP (in_channel, mlp), on a KITTI cloud in xyz
SSG_SA = ((1024, 0.1, 32, 3, (32, 32, 64)),
          (256, 0.2, 32, 67, (64, 64, 128)),
          (64, 0.4, 32, 131, (128, 128, 256)),
          (16, 0.8, 32, 259, (256, 256, 512)))
SSG_FP = ((768, (256, 256)), (384, (256, 256)), (320, (256, 128)),
          (128, (128, 128, 128)))
MODULES_DIR = "build/modules"


def ssg_model(torch, dev):
    """The SSG stack with random weights from seed 0, in train mode."""
    from cmr_agent_tpu_torch.models import pointnet as pn
    from cmr_agent_tpu_torch.serve import init_random_
    model = torch.nn.ModuleDict({
        "sa": torch.nn.ModuleList(pn.PointNetSetAbstraction(*a)
                                  for a in SSG_SA),
        "fp": torch.nn.ModuleList(pn.PointNetFeaturePropagation(*a)
                                  for a in SSG_FP)})
    init_random_(model, torch.Generator().manual_seed(0))
    return model.to(dev).train()


def ssg_forward(model, xyz):
    """Per-point features ``[B, N, 128]``: the SA levels down, the FP
    levels back up."""
    xyzs, feats = [xyz], [None]
    for sa in model["sa"]:
        x, f = sa(xyzs[-1], feats[-1])
        xyzs.append(x)
        feats.append(f)
    f = feats[-1]
    for i, fp in enumerate(model["fp"]):
        lvl = len(SSG_SA) - 1 - i
        f = fp(xyzs[lvl], xyzs[lvl + 1], feats[lvl], f)
    return f


def run_pointnet(torch, kernels, serve, kitti_config, dev) -> None:
    """``[pointnet]``: the SSG stack's forward and backward at B = 8 on a
    KITTI cloud with the launches counted, then the kernels twin against
    the plain twin (outputs within atol 1e-4, gradients under phase 6's
    rule)."""
    xyz = serve.synthetic_batch(kitti_config(), B, dev, seed=0)["pc"]
    xyz = xyz.float().contiguous()
    model = ssg_model(torch, dev)
    gen = torch.Generator().manual_seed(5)
    ct = {}

    def fwd_bwd(points):
        model.zero_grad(set_to_none=True)
        out = ssg_forward(model, points)
        if "ct" not in ct:
            ct["ct"] = torch.randn(out.shape, generator=gen).to(dev)
        (out * ct["ct"]).sum().backward()
        return out.detach(), {n: p.grad.detach().clone()
                              for n, p in model.named_parameters()}

    ssg_forward(model, xyz)                  # warm-up (cuBLAS, the allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out, fwd_s = timed(torch, lambda: ssg_forward(model, xyz))
    ct["ct"] = torch.randn(out.shape, generator=gen).to(dev)
    _, bwd_s = timed(torch, lambda: (out * ct["ct"]).sum().backward())
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    got_out, got = fwd_bwd(xyz)
    # the nudge floor: the cotangent nudged in its last bits. The forward's
    # choices (FPS, ball query, the max pooling) must stay put: a nudged
    # cloud or weight flips near-tied maxima, which moves whole gradient
    # rows, while the twins' forwards are the same bits (the gather is a
    # copy) and only their backward sums differ
    nudges = [1.0 + s * 2.0 ** -e for e in (23, 22) for s in (1.0, -1.0)]
    with plain_kernels(kernels):
        want_out, want = fwd_bwd(xyz)
        nudged, base = [], ct["ct"]
        for f in nudges:
            ct["ct"] = base * f
            nudged.append(fwd_bwd(xyz)[1])
        ct["ct"] = base
    out_diff = (got_out - want_out).abs().max().item()
    line("pointnet", shape=repr(tuple(out.shape)),
         forward_ms=f"{fwd_s * 1e3:.2f}", backward_ms=f"{bwd_s * 1e3:.2f}",
         peak_gib=f"{peak:.2f}", gather_rows_launches=counts["gather_rows"],
         segment_sum_launches=counts["segment_sum"],
         launches=repr({k: v for k, v in counts.items() if v}),
         out_max_diff_vs_plain=f"{out_diff:.3e}")
    assert counts["gather_rows"] > 0, counts
    assert torch.isfinite(out).all()
    assert out_diff <= 1e-4, out_diff
    hold_gradients("pointnet_vs_plain", got, want, nudged)


class _Start:
    """A generator stand-in whose one draw is the FPS start index: the
    host FPS draws its start from ``rng.integers(n)``."""

    def __init__(self, i: int):
        self.i = i

    def integers(self, n):
        return self.i


def run_sampling_ops(torch, kernels, serve, kitti_config, dev) -> None:
    """``[sampling_ops]``: FPS 40960 -> 1280 and the 1-NN assignment equal
    to the host versions in ``native/`` (on a 1/8 m grid, where every
    squared distance is exact in both); the ball query and the segment
    ops against the CPU's results on the same inputs; each op's ms."""
    from cmr_agent_tpu_torch.native import fps_native, nn_assign_native
    from cmr_agent_tpu_torch.ops import sampling, scatter
    pc = serve.synthetic_batch(kitti_config(), B, dev, seed=0)["pc"].float()
    pts = torch.round(pc * 8) / 8
    host_pts = pts.cpu().numpy()
    init = torch.randint(0, N_PT, (B,),
                         generator=torch.Generator().manual_seed(3))
    fps = lambda: sampling.farthest_point_sample(pts, N_NODE, init_idx=init)
    idx = fps()
    want = np.stack([fps_native(_Start(int(i)), p, N_NODE)
                     for i, p in zip(init, host_pts)])
    same = np.array_equal(idx.cpu().numpy(), want)
    line("sampling_ops", op="farthest_point_sample",
         shape=repr((B, N_PT, N_NODE)), equal_to_native=same,
         ms=f"{cuda_ms(fps, 2):.3f}")
    assert same
    centres = torch.gather(pts, 1, idx.long()[..., None].expand(-1, -1, 3))
    assign = sampling.nearest_assign(pts, centres)
    want = np.stack([nn_assign_native(p, c) for p, c in
                     zip(host_pts, centres.cpu().numpy())])
    same = np.array_equal(assign.cpu().numpy(), want)
    line("sampling_ops", op="nearest_assign",
         shape=repr((B, N_PT, N_NODE)), equal_to_native=same,
         ms=f"{cuda_ms(lambda: sampling.nearest_assign(pts, centres), 5):.3f}")
    assert same
    ball = lambda x, c: sampling.query_ball_point(2.0, 32, x, c)
    got = ball(pts[:2], centres[:2, :256])
    same = torch.equal(got.cpu(), ball(pts[:2].cpu(), centres[:2, :256].cpu()))
    line("sampling_ops", op="query_ball_point", radius=2.0, nsample=32,
         equal_to_cpu=same, full_rows=int((got != got[..., :1]).all(-1)
                                          .sum()),
         ms=f"{cuda_ms(lambda: ball(pts, centres), 3):.3f}")
    assert same
    _, randn, _ = rand_factory(torch, 23, dev)
    data = randn(B, N_PT, F)
    ids = assign
    cases = (
        ("segment_sum", lambda d, i: scatter.segment_sum(d[0], i[0], N_NODE,
                                                         "scatter")),
        ("segment_sum_matmul", lambda d, i: scatter.segment_sum(
            d[0], i[0], N_NODE, "matmul")),
        ("segment_max", lambda d, i: scatter.segment_max(d[0], i[0], N_NODE)),
        ("segment_mean", lambda d, i: scatter.segment_mean(d[0], i[0],
                                                           N_NODE)),
        ("segment_softmax_attend", lambda d, i: scatter.segment_softmax_attend(
            d[0], d[1], i[0], N_NODE)),
        ("batched_segment_sum", lambda d, i: scatter.batched_segment_sum(
            d[:2], i[:2], N_NODE, "scatter")),
        ("batched_segment_max", lambda d, i: scatter.batched_segment_max(
            d[:2], i[:2], N_NODE)),
        ("batched_segment_mean", lambda d, i: scatter.batched_segment_mean(
            d[:2], i[:2], N_NODE, "scatter")))
    for name, fn in cases:
        got, want = fn(data, ids).cpu(), fn(data.cpu(), ids.cpu())
        if name.endswith("segment_max"):
            ok = torch.equal(got, want)
        elif name == "segment_softmax_attend":
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            # the sums in another order: within 1e-6 of the segment's sum
            # of magnitudes (the CPU tests' rule)
            mags = fn(data.abs(), ids).cpu()
            ok = bool(((got - want).abs() <= 1e-6 * mags + 1e-7).all())
        line("sampling_ops", op=name, shape=repr(tuple(data[0].shape)),
             segments=N_NODE, within_cpu_tolerance=ok,
             max_diff=f"{(got - want).abs().max().item():.3e}",
             ms=f"{cuda_ms(lambda: fn(data, ids), 5):.4f}")
        assert ok, name


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_parallel_ranks(torch, serve, kitti_config, dev) -> tuple:
    """Phase 22's two gloo ranks on the one card, started at the phase's
    start with the B = 8 train batch in their directory (this process's
    copy, cached since phase 6): each sets up, then waits for ``go``
    there. Returns ``(procs, directory)``."""
    import os
    import shutil
    d = os.path.join(MODULES_DIR, "parallel")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    batch = serve.synthetic_batch(kitti_config(), B, dev, seed=0,
                                  keys=serve.TRAIN_KEYS)
    torch.save({k: v.cpu() for k, v in batch.items()},
               os.path.join(d, "batch.pt"))
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, __file__, "--parallel-worker",
                               str(r), d, port]) for r in range(2)]
    return procs, d


def parallel_worker(torch, kernels, serve, kitti_config, rank: int, d: str,
                    port: str) -> None:
    """One of phase 22's two ranks (``--parallel-worker RANK DIR PORT``):
    the dp geo step on its 4 rows of the B = 8 batch over gloo, which
    all-reduces CUDA tensors, and the sp message of its token shards;
    results to ``DIR/rank<RANK>.pt``."""
    import os
    from cmr_agent_tpu_torch.parallel import distributed as D
    from cmr_agent_tpu_torch.parallel import mesh as M
    from cmr_agent_tpu_torch.parallel.sp import sp_linear_attention_message
    from cmr_agent_tpu_torch.train import train_geo
    dev = torch.device("cuda")
    kernels.library()
    # set up while the main process runs the phase's first parts (mostly
    # host work: the batch's scenes), then wait for "go"
    D.initialize(f"127.0.0.1:{port}", 2, rank, device="cuda",
                 backend="gloo", timeout_s=300)
    dp = M.make_mesh((2,), ("dp",), device="cuda")
    sp = M.make_mesh((1, 2), ("dp", "sp"), device="cuda")
    cfg = kitti_config()
    batch = {k: v.to(dev) for k, v in
             torch.load(os.path.join(d, "batch.pt")).items()}
    state = train_geo.create_geo_state(cfg, dev, seed=0)
    M.replicate(state.model, dp)
    step = M.make_sharded_geo_train_step(cfg, dp)
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = parallel_qkv(torch, dev)
    torch.cuda.synchronize()
    wait_for(os.path.join(d, "go"), 900)
    kernels.reset_launch_counts()
    metrics, seconds = timed(torch, lambda: step(state, batch, gen))
    counts = {k_: v_ for k_, v_ in kernels.launch_counts().items() if v_}
    lq, lk = q.shape[1] // 2, k.shape[1] // 2
    msg = sp_linear_attention_message(
        q[:, rank * lq:(rank + 1) * lq], k[:, rank * lk:(rank + 1) * lk],
        v[:, rank * lk:(rank + 1) * lk], sp.group("sp"))
    torch.save({"metrics": {k_: v_.item() for k_, v_ in metrics.items()},
                "checksum": param_checksum(state.model), "seconds": seconds,
                "launches": counts, "sp_message": msg.cpu()},
               os.path.join(d, f"rank{rank}.pt"))
    D.barrier("done", timeout_s=300)
    D.shutdown()


def parallel_qkv(torch, dev):
    """The sp check's feature-mapped q [B, 1280, 4, 32] (the nodes) and
    k / v [B, 5120, 4, 32] (the pixels) from seed 11."""
    gen = torch.Generator().manual_seed(11)
    q = torch.rand(B, N_NODE, 4, 32, generator=gen) + 0.5
    k = torch.rand(B, 5120, 4, 32, generator=gen) + 0.5
    v = torch.randn(B, 5120, 4, 32, generator=gen)
    return q.to(dev), k.to(dev), v.to(dev)


def param_checksum(model) -> float:
    return float(sum(p.detach().double().abs().sum().item()
                     for p in model.parameters()))


def run_parallel(torch, kernels, serve, kitti_config, dev, procs,
                 d: str) -> None:
    """``[parallel]``: ``initialize`` at world size 1 over NCCL, its dp
    step the same bits as ``make_geo_train_step`` (deterministic
    algorithms on for both); then the two gloo ranks' dp step at B = 8
    against the single-process step (step-0 loss within rtol 1e-6, the
    parameters' checksum after the step within rtol 5e-5), and their sp
    message shards against the unsharded message (rtol 1e-5)."""
    import os
    from cmr_agent_tpu_torch.parallel import distributed as D
    from cmr_agent_tpu_torch.parallel import mesh as M
    from cmr_agent_tpu_torch.parallel.sp import linear_attention_message
    from cmr_agent_tpu_torch.train import train_geo
    with open(os.path.join(d, "go"), "w"):
        pass                                  # the ranks start meanwhile
    cfg = kitti_config()
    batch = serve.synthetic_batch(cfg, B, dev, seed=0, keys=serve.TRAIN_KEYS)
    D.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        states, metrics = [], []
        for make in (lambda: M.make_sharded_geo_train_step(
                         cfg, M.make_mesh(device="cuda")),
                     lambda: train_geo.make_geo_train_step(cfg)):
            state = train_geo.create_geo_state(cfg, dev, seed=0)
            gen = torch.Generator(device=dev).manual_seed(1)
            metrics.append(make()(state, batch, gen))
            states.append(state)
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic = saved[1]
        D.shutdown()
    same = (all(torch.equal(metrics[0][k], metrics[1][k])
                for k in metrics[1])
            and all(torch.equal(a, b) for a, b in zip(
                states[0].model.state_dict().values(),
                states[1].model.state_dict().values())))
    line("parallel", world=1, backend="nccl", same_bits_as_train_step=same)
    assert same
    want_loss = metrics[1]["loss"].item()
    want_sum = param_checksum(states[1].model)
    del states
    for p in procs:
        rc = p.wait(timeout=600)
        assert rc == 0, f"a gloo rank exited {rc} (gloo refusing CUDA " \
                        f"tensors fails here too)"
    ranks = [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(2)]
    q, k, v = parallel_qkv(torch, dev)
    msg = linear_attention_message(q, k, v)
    half = q.shape[1] // 2
    for r, res in enumerate(ranks):
        loss_rel = abs(res["metrics"]["loss"] - want_loss) / abs(want_loss)
        sum_rel = abs(res["checksum"] - want_sum) / abs(want_sum)
        shard = msg[:, r * half:(r + 1) * half].cpu()
        # the largest difference over its tolerance (rtol 1e-5, atol 1e-6)
        sp_vs_tol = ((res["sp_message"] - shard).abs()
                     / (1e-6 + 1e-5 * shard.abs())).max().item()
        m = res["metrics"]
        line("parallel", world=2, backend="gloo", rank=r,
             step_s=f"{res['seconds']:.3f}", loss=f"{m['loss']:.7f}",
             loss_single=f"{want_loss:.7f}", loss_rel_diff=f"{loss_rel:.2e}",
             checksum_rel_diff=f"{sum_rel:.2e}",
             pc_overlap_precision=f"{m['pc_overlap_precision']:.6f}",
             launches=repr(res["launches"]),
             sp_message_max_diff_over_tol=f"{sp_vs_tol:.3f}")
        assert loss_rel <= 1e-6 and sum_rel <= 5e-5, (loss_rel, sum_rel)
        torch.testing.assert_close(res["sp_message"], shard, rtol=1e-5,
                                   atol=1e-6)


def run_diagnose(torch, kernels) -> None:
    """``[diagnose]``: ``diagnose_agent --full`` at the committed geo_45 /
    agent_45 weights, pool 8, batch 8; its table relayed, then each
    kernel's launches over the run."""
    from cmr_agent_tpu_torch.tools import diagnose_agent
    kernels.reset_launch_counts()
    out, _ = run_cli("diagnose", diagnose_agent.main, [
        "--full", "--pool-size", "8", "--batch-size", "8", "--geo-ckpt",
        "runs_r4/geo_45", "--agent-ckpt", "runs_r4/agent_45", "--pose-aware",
        "--aux-head", "--bearing-init", "--device", "cuda"])
    counts = kernels.launch_counts()
    line("diagnose", launches=repr({k: v for k, v in counts.items() if v}),
         rte_first=f"{out['rte'][0].mean():.3f}",
         rte_last=f"{out['rte'][-1].mean():.3f}")
    assert np.isfinite(out["rte"]).all() and np.isfinite(out["rre"]).all()
    assert counts["segment_softmax_attend"] > 0 and counts["knn"] > 0


def run_int8_probe(torch) -> None:
    """``[int8_probe]``: the three chains' ms/iter at B = 8, N = 40960,
    F = 64 and the projected episode gain from this card's own trace of a
    bf16 episode."""
    from cmr_agent_tpu_torch.tools import int8_probe
    out = run_tool("int8_probe", int8_probe.main,
                   ["--iters", "10", "--episode-iters", "2"])
    assert all(out[k] > 0 for k in ("bf16_ms", "int8_ms", "int8mm_ms",
                                    "episode_ms")), out
    assert 0 < out["stack_share"] <= 1, out


def run_visualize(torch, kernels, kitti_config, dev) -> None:
    """``[visualize]``: the expert's rollout on one KITTI-width sample on
    the card (its RTE and RRE must descend), and an untrained agent's on
    random geo outputs with the launches counted (no rendering: the card's
    host has neither matplotlib nor Pillow)."""
    from cmr_agent_tpu_torch.data import SyntheticDataset, collate
    from cmr_agent_tpu_torch.models.agent import CMRAgent
    from cmr_agent_tpu_torch.native import get_fast_host_ops
    from cmr_agent_tpu_torch.serve import init_random_
    from cmr_agent_tpu_torch.tools import visualize
    cfg = kitti_config()
    fps_fn, nn_fn = get_fast_host_ops()
    batch = collate([SyntheticDataset(cfg, length=1, seed=3, fps_fn=fps_fn,
                                      nn_fn=nn_fn)[0]])
    kernels.reset_launch_counts()
    rec, seconds = timed(torch, lambda: visualize.rollout(
        cfg, batch, "expert", device=dev))
    line("visualize", policy="expert", seconds=f"{seconds:.3f}",
         rte=",".join(f"{e:.3f}" for e in rec["rte"]),
         rre=",".join(f"{e:.3f}" for e in rec["rre"]),
         launches=sum(kernels.launch_counts().values()))
    assert rec["rte"][-1] < rec["rte"][0] and rec["rre"][-1] < rec["rre"][0]
    agent = CMRAgent(cfg)
    init_random_(agent, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(4)
    geo_vars = {"pc_overlap_pred": torch.from_numpy(batch["pc_mask"]).bool(),
                "pc_geo_feat": torch.randn(1, cfg.num_pt, cfg.embed_dim,
                                           generator=gen),
                "img_geo_feat": torch.randn(1, cfg.image_h, cfg.image_w,
                                            cfg.embed_dim, generator=gen)}
    kernels.reset_launch_counts()
    rec, seconds = timed(torch, lambda: visualize.rollout(
        cfg, batch, "untrained", geo_vars, agent.to(dev).eval(), device=dev))
    counts = kernels.launch_counts()
    line("visualize", policy="untrained", seconds=f"{seconds:.3f}",
         rte_last=f"{rec['rte'][-1]:.3f}",
         launches=repr({k: v for k, v in counts.items() if v}))
    assert np.isfinite(rec["rte"]).all()
    assert counts["segment_mean_count_image"] == cfg.action_num, counts


def run_modules(torch, kernels, serve, kitti_config, dev) -> None:
    """Phase 22 (``--phase modules``): the last modules on the card, each
    part on lines of its own, with its seconds on ``[modules_part]``."""
    import gc
    procs, d = start_parallel_ranks(torch, serve, kitti_config, dev)
    try:
        for name, fn in (
                ("pointnet", lambda: run_pointnet(torch, kernels, serve,
                                                  kitti_config, dev)),
                ("sampling_ops", lambda: run_sampling_ops(
                    torch, kernels, serve, kitti_config, dev)),
                ("parallel", lambda: run_parallel(
                    torch, kernels, serve, kitti_config, dev, procs, d)),
                ("diagnose", lambda: run_diagnose(torch, kernels)),
                ("int8_probe", lambda: run_int8_probe(torch)),
                ("visualize", lambda: run_visualize(
                    torch, kernels, kitti_config, dev))):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            line("modules_part", name=name,
                 seconds=f"{time.perf_counter() - t0:.1f}")
    finally:
        stop(procs)


def run_phase(torch, kernels, serve, kitti_config, dev, phase: str,
              repeat: int, hypotheses: int = 13) -> int:
    """One phase alone, ``repeat`` times: "geo_train" phase 6's gate (the
    twins' gradients and losses, without the timed steps), "segment_sums"
    the gates and times of kernels 5 and 7 from phases 5 and 8, "chains"
    phase 12, "knn_raster" phase 16 (kernels 3 and 4), "softmax_image"
    phase 17 (kernels 1 and 6a), "compact_pack" kernels 11 and 8 from
    phases 8 and 14, "factored" kernel 6b and the raster probes from phase
    15, "eval" phase 18 (the E7 evaluation), "export" phase 19 (the
    composed artifact at ``hypotheses`` candidates), "train" phase 20 (the
    training entry points), "inputs" phase 21 (the reference's inputs),
    "modules" phase 22 (the last modules). Returns the number of repeats
    that failed their gate."""
    failed = 0
    if phase == "train":
        # once: after a repeat this process's allocator pins segments the
        # worker's step needs (see run_iter_worker)
        run_iter_worker(torch)
    if phase == "segment_sums":
        geo_calls = geo_step_segment_calls(torch, kernels, serve, kitti_config,
                                           dev)
        warp_calls = warp_segment_calls(torch, kernels, serve, kitti_config)
    for i in range(repeat):
        try:
            if phase == "geo_train":
                cfg = kitti_config()
                batch = serve.synthetic_batch(cfg, B, dev, seed=0,
                                              keys=serve.TRAIN_KEYS)
                compare_geo_twins(torch, kernels, cfg, batch, dev)
            elif phase == "knn_raster":
                check_knn_raster(torch, kernels, serve, kitti_config, dev)
            elif phase == "softmax_image":
                check_softmax_image(torch, kernels, serve, kitti_config, dev)
            elif phase == "compact_pack":
                check_compact_pack(torch, kernels, serve, kitti_config, dev)
            elif phase == "factored":
                check_factored_kernel(torch, kernels, dev)
                run_raster_probes(torch, kernels, run_tool)
            elif phase == "eval":
                run_eval(torch, kernels, dev)
            elif phase == "export":
                run_export(torch, hypotheses)
            elif phase == "train":
                run_train(torch, kernels, serve, dev)
            elif phase == "inputs":
                run_inputs(torch, kernels, serve, dev)
            elif phase == "modules":
                run_modules(torch, kernels, serve, kitti_config, dev)
            elif phase == "segment_sums":
                _, randn, randint = rand_factory(torch, 4321, dev)
                check_segment_sum(torch, kernels, dev, randn, randint,
                                  geo_calls)
                _, randn, randint = rand_factory(torch, 777, dev)
                check_segment_sum_shared(torch, kernels, dev, randn, randint,
                                         lambda: warp_calls)
            else:
                check_chain_kernels(torch, kernels, dev)
            line("phase_gate", phase=phase, repeat=i, passed=True)
        except AssertionError as e:
            failed += 1
            line("phase_gate", phase=phase, repeat=i, passed=False,
                 error=repr(str(e)[:300]))
        torch.cuda.empty_cache()
    return failed


def main(argv=None) -> int:
    """Every phase, with no arguments. ``--phase
    geo_train|segment_sums|chains|knn_raster|softmax_image|compact_pack|
    factored|eval|export|train|inputs|modules [--repeat N] [--hypotheses
    K]``
    builds the kernels and runs that one phase N times instead (exit code 1
    if any repeat failed its gate); ``--hypotheses`` is the composed
    artifact's K under ``--phase export`` (13, E7's)."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase",
                    choices=("all", "geo_train", "segment_sums", "chains",
                             "knn_raster", "softmax_image", "compact_pack",
                             "factored", "eval", "export", "train",
                             "inputs", "modules"),
                    default="all")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--hypotheses", type=int, default=13)
    ap.add_argument("--export-worker",
                    choices=export_labels(True),
                    help="one exporter of phase 19, which starts them")
    ap.add_argument("--iter-cli-worker", metavar="DIR",
                    help="phase 20's train_iter run without remat, its "
                         "checkpoints under DIR")
    ap.add_argument("--parallel-worker", nargs=3,
                    metavar=("RANK", "DIR", "PORT"),
                    help="one of phase 22's two gloo ranks")
    opts = ap.parse_args(argv)
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
    if opts.iter_cli_worker:
        run_iter_cli(torch, kernels, opts.iter_cli_worker, "plain")
        return 0
    if opts.export_worker:
        export_worker(torch, kernels, serve, kitti_config, dev,
                      opts.export_worker, opts.hypotheses)
        return 0
    if opts.parallel_worker:
        rank, d, port = opts.parallel_worker
        parallel_worker(torch, kernels, serve, kitti_config, int(rank), d,
                        port)
        return 0
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
    if opts.phase in ("all", "segment_sums"):
        print_ptxas(build, "segment_sum", SEGMENT_SUM_KERNEL_NAMES,
                    int_template)
        print_ptxas(build, "segment_sum_shared",
                    SEGMENT_SUM_SHARED_KERNEL_NAMES, int_template)
    if opts.phase != "all":
        failed = run_phase(torch, kernels, serve, kitti_config, dev,
                           opts.phase, opts.repeat, opts.hypotheses)
        print(smi, flush=True)
        return 1 if failed else 0

    t0 = time.perf_counter()
    run_iter_worker(torch)
    line("train_part", name="train_iter_cli_plain",
         seconds=f"{time.perf_counter() - t0:.1f}")
    stamp = [time.perf_counter()]

    def phase_done(phases: str) -> None:
        now = time.perf_counter()
        line("phase_seconds", phases=phases, seconds=f"{now - stamp[0]:.1f}")
        stamp[0] = now

    rows = check_kernels(torch, kernels, dev)
    phase_done("3")
    counts, _ = run_path(torch, kernels, serve, kitti_config, "float32")
    bf16_counts, _ = run_path(torch, kernels, serve, kitti_config, "bfloat16")
    phase_done("4")

    train_rows, _ = check_train_kernels(torch, kernels, serve, kitti_config,
                                        dev)
    rows.update(train_rows)
    phase_done("5")
    geo_counts, geo_state, train_batch = run_geo_train(
        torch, kernels, serve, kitti_config(), dev)
    phase_done("6")
    agent_counts = run_agent_train(torch, kernels, kitti_config(),
                                   geo_state.model, train_batch, dev)
    del geo_state, train_batch
    torch.cuda.empty_cache()
    phase_done("7")

    rows.update(check_compose_kernels(torch, kernels, serve, kitti_config,
                                      dev))
    run_itermodel(torch, kernels, serve, kitti_config)
    torch.cuda.empty_cache()
    phase_done("8-9")
    composed_counts = run_composed(torch, kernels, serve, kitti_config,
                                   "float32")
    torch.cuda.empty_cache()
    run_composed(torch, kernels, serve, kitti_config, "bfloat16")
    torch.cuda.empty_cache()
    phase_done("10")
    pack_counts = run_packed_episode(torch, kernels, serve, kitti_config,
                                     "pack")
    run_packed_episode(torch, kernels, serve, kitti_config, "mega")
    torch.cuda.empty_cache()
    phase_done("11")

    t0 = time.perf_counter()
    rows.update(check_chain_kernels(torch, kernels, dev))
    fused_counts = run_fused_path(torch, kernels, serve, kitti_config,
                                  "float32")
    run_fused_path(torch, kernels, serve, kitti_config, "bfloat16")
    raster_rows, compact_counts, flat_counts = run_raster_episodes(
        torch, kernels, serve, kitti_config)
    rows.update(raster_rows)
    line("fourth_slice_phases", seconds=f"{time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rows["segment_sum_image_factored"] = check_factored_kernel(torch, kernels,
                                                               dev)
    factored_launches = run_tools(torch, kernels)
    line("fifth_slice_phases", seconds=f"{time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    check_knn_raster(torch, kernels, serve, kitti_config, dev)
    line("eighth_slice_phase", seconds=f"{time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    check_softmax_image(torch, kernels, serve, kitti_config, dev)
    line("ninth_slice_phase", seconds=f"{time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    run_eval(torch, kernels, dev)
    line("twelfth_slice_phase", seconds=f"{time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    run_export(torch)
    line("thirteenth_slice_phase", seconds=f"{time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    run_train(torch, kernels, serve, dev)
    line("fourteenth_slice_phase", seconds=f"{time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    run_inputs(torch, kernels, serve, dev)
    line("fifteenth_slice_phase", seconds=f"{time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    run_modules(torch, kernels, serve, kitti_config, dev)
    line("sixteenth_slice_phase", seconds=f"{time.perf_counter() - t0:.1f}")
    # each kernel's launches on the path that runs it: the serving episode
    # (f32; kernel 1's bf16 row the bf16 one), one geo train step, the
    # agent training run, one composed request, the "pack" episode, the
    # fused ("all", f32) episode, the "compact" (f32) or the "flat" (bf16 +
    # int8) episode, the three raster probes
    counts["segment_softmax_attend_bf16"] = bf16_counts[
        "segment_softmax_attend"]
    counts.update({k: geo_counts[k] for k in ("segment_sum",
                                               "segment_softmax_attend_backward")})
    counts["segment_mean_count_image"] = agent_counts["segment_mean_count_image"]
    counts["segment_sum_shared"] = composed_counts["segment_sum_shared"]
    counts["mask_compact_pack"] = pack_counts["mask_compact_pack"]
    counts["fused_dense_chain"] = fused_counts["fused_dense_chain"]
    counts["fused_dense_chain_cn"] = fused_counts["fused_dense_chain_cn"]
    counts["segment_sum_count_image_compact"] = compact_counts[
        "segment_sum_count_image_compact"]
    counts["segment_mean_count_image_int8"] = flat_counts[
        "segment_mean_count_image"]
    counts["segment_sum_image_factored"] = factored_launches

    sources = {
        "segment_softmax_attend": ("segment_softmax.cu", 126),
        "segment_softmax_attend_bf16": ("segment_softmax.cu", 126),
        "gather_rows": ("gather_rows.cu", 489),
        "knn": ("knn.cu", 395),
        "segment_mean_count_image_project": ("raster.cu", 1579),
        "segment_sum": ("segment_sum.cu", 258),
        "segment_softmax_attend_backward": ("segment_softmax_backward.cu",
                                            145),
        "segment_mean_count_image": ("raster.cu", 685),
        "segment_sum_shared": ("segment_sum_shared.cu", 320),
        "mask_compact_pack": ("mask_pack.cu", 1467),
        "fused_dense_chain": ("dense_chain.cu", 1138),
        "fused_dense_chain_cn": ("dense_chain.cu", 1347),
        "segment_sum_count_image_compact": ("raster.cu", 857),
        "segment_mean_count_image_int8": ("raster.cu", 685),
        "segment_sum_image_factored": ("raster.cu", 685),
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
