"""Evaluate iterative agent registration (counterpart of the JAX package's
``cli/test_agent.py``; reference Test_Agent.py).

Runs the geo forward and the deterministic refinement episode per batch,
optionally behind the cost volume's coarse search over several yaw
hypotheses with feature-alignment verification, verified refinement
rounds and a re-voted beam of refined candidates, and reports
registration recall, RTE / RRE, the oracle ceilings of the hypothesis and
the beam selections, and the time per pair. The flags and the printed
JSON are the JAX package's; ``--device`` picks the card (default) or the
CPU.

Usage (the flagship evaluation, E7 of ``runs_r5/README.md``)::

    python -m cmr_agent_tpu_torch.cli.test_agent --dataset synthetic \\
      --synthetic-scene structured --synthetic-length 64 --dtype bfloat16 \\
      --iter-ckpt checkpoint/iter_kitti/epoch-1-step-10000 \\
      --geo-ckpt runs_r4/geo_pi --fine-geo-ckpt runs_r4/geo_45 \\
      --agent-ckpt runs_r4/agent_45 --unmasked-warp --pose-aware \\
      --aux-head --bearing-init --hypo-score combo --refine-rounds 1 \\
      --eval-batch-size 8 --iter-hypotheses 13 \\
      --refine-beam combo,mean_valid,ir_smooth --beam-score above50_norm
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import serve
from ..env.environment import apply_coarse_pose, compose_disentangled
from ..models.cost_volume import IterModel
from ..models.agent import CMRAgent
from ..ops.geometry import pose_diff, to_disentangled
from ..train.metrics import registration_metrics
from ..train.train_iter import iter_model_state
from .common import (add_common_args, apply_obs_overrides, build_config,
                     build_dataset, load_geo_variables, load_model,
                     make_loader, require_batches, set_seed,
                     to_device, maybe_initialize_distributed)

STATS = ("smooth_mean", "sum_norm", "mean_valid", "frac_valid",
         "above50_norm", "above70_norm", "ir_smooth", "ir_mean", "ir_norm",
         "combo")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(p)
    p.add_argument("--geo-ckpt", default="")
    p.add_argument("--agent-ckpt", default="",
                   help="agent checkpoint (a port train checkpoint or "
                        "snapshot, a weight export or the Orbax tree it "
                        "came from)")
    p.add_argument("--iter-ckpt", default="",
                   help="coarse-to-fine: an IterModel checkpoint runs "
                        "--iter-iters cost-volume iterations first, the "
                        "problem is re-based under the coarse pose, the geo "
                        "model re-perceives the near-aligned cloud, and the "
                        "agent refines from there")
    p.add_argument("--iter-iters", type=int, default=2,
                   help="cost-volume iterations before the agent episode")
    p.add_argument("--iter-hypotheses", type=int, default=1,
                   help="refine the top-N yaw candidates of the first "
                        "cost-volume decode through the fine stage and keep, "
                        "per sample, the one with the best ground-truth-free "
                        "verification score (--hypo-score); 1 = one "
                        "hypothesis")
    p.add_argument("--hypo-score", default="smooth_mean", choices=STATS,
                   help="verification statistic that selects among the "
                        "--iter-hypotheses candidates; 'combo' = "
                        "z(smooth_mean) + 0.3 z(ir_smooth) across the "
                        "candidates of a sample")
    p.add_argument("--refine-rounds", type=int, default=0,
                   help="verified refinement rounds after the (selected) "
                        "fine stage: re-base under the composed estimate, "
                        "re-perceive with the fine geo model, run another "
                        "episode, and accept per sample only where the "
                        "verification statistic improves; 0 = off")
    p.add_argument("--refine-beam", default="",
                   help="comma-separated statistics ('stat:R' nominates "
                        "that statistic's rank-R candidate), each seeding its "
                        "own verified refinement; the final pose is re-voted "
                        "across the refined beam by --beam-score. Needs "
                        "--iter-hypotheses > 1 and --refine-rounds > 0")
    p.add_argument("--beam-score", default="", choices=("",) + STATS,
                   help="statistic of the post-refinement beam re-vote "
                        "(default --hypo-score)")
    p.add_argument("--beam-frame", default="own", choices=["own", "shared"],
                   help="'own': each member scored in its final round's "
                        "perception frame; 'shared': every member's pose "
                        "scored in every member's frame, z-scored across "
                        "poses per frame and averaged over frames")
    p.add_argument("--refine-iter", action="store_true",
                   help="each refinement round first re-decodes the "
                        "residual with the cost volume on a grid shrunk by "
                        "--refine-shrink (requires --iter-ckpt)")
    p.add_argument("--refine-shrink", type=float, default=0.25,
                   help="amplitude factor of the --refine-iter grid")
    p.add_argument("--iter-shrink", type=float, default=1.0,
                   help="cost-volume iteration i > 0 scales R/T_amplitude "
                        "by this factor (1.0 = the reference's fixed grid)")
    p.add_argument("--fine-geo-ckpt", default="",
                   help="a second geo checkpoint for the fine stage "
                        "(re-perception and episodes); --geo-ckpt feeds the "
                        "cost volume. Defaults to --geo-ckpt")
    p.add_argument("--unmasked-warp", action="store_true",
                   help="warp ALL points in the cost volume "
                        "(Config.cost_volume_unmasked); must match how the "
                        "IterModel ckpt was trained")
    p.add_argument("--eval-batch-size", type=int, default=1,
                   help="the reference protocol uses 1")
    p.add_argument("--max-batches", type=int, default=0)
    p.add_argument("--t-amp", type=float, default=None,
                   help="translation perturbation amplitude override (m)")
    p.add_argument("--r-amp", type=float, default=None,
                   help="yaw perturbation amplitude override (rad)")
    p.add_argument("--save-mat", default="",
                   help="dump the per-sample errors, timings and candidate "
                        "matrices to a .mat file")
    p.add_argument("--pose-aware", action="store_true",
                   help="pose-aware 3-D observation "
                        "(Config.pose_aware_observation)")
    p.add_argument("--obs-bearing", action="store_true",
                   help="bearing observation channels "
                        "(Config.obs_bearing_channels)")
    p.add_argument("--aux-head", action="store_true",
                   help="bearing statistic into the policy/value heads "
                        "(Config.policy_aux_state; implies --obs-bearing)")
    p.add_argument("--bearing-init", action="store_true",
                   help="start every episode from the predicted-overlap "
                        "bearing yaw (Config.bearing_init)")
    return p


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _stat_arrays(stats) -> dict:
    """The statistics ``[B, K]`` as numpy arrays, in the JAX CLI's order
    (its jitted scoring returns them sorted by name; ``combo`` last)."""
    return {k: _numpy(stats[k])
            for k in sorted(stats, key=lambda k: (k == "combo", k))}


def solved(rte, rre) -> np.ndarray:
    """The registration-recall thresholds: RTE < 5 m and RRE < 10 deg."""
    return (np.asarray(rte) < 5.0) & (np.asarray(rre) < 10.0)


def errors(final, batch, base=None):
    """The eval episode's RTE, RRE ``[B]`` (``make_val_episode_fn``): the
    disentangled estimate ``final`` against the ground truth of ``batch``
    rebased under ``base``."""
    if base is not None:
        batch = apply_coarse_pose(batch, base)
    rte, rre = pose_diff(final, to_disentangled(batch["P"].float(),
                                                batch["pc"]))
    return _numpy(rte), _numpy(rre)


def refined_errors(batch, rounds, rte, rre):
    """RTE, RRE after the verified refinement ``rounds`` (those of
    ``serve.CoarseToFine.refine``) from ``rte``, ``rre``: a sample takes a
    round's errors where the round was accepted."""
    for r in rounds:
        rte_r, rre_r = errors(r["final"], batch, r["base"])
        acc = _numpy(r["accept"]).astype(bool)
        rte, rre = np.where(acc, rte_r, rte), np.where(acc, rre_r, rre)
    return rte, rre


def prepare(argv=None):
    """Parse ``argv``, load the modules and build the per-batch evaluation.
    Returns ``(args, cfg, loader, evaluate)``; ``evaluate(batch)`` takes a
    batch of tensors on the device and returns its record: ``rte``,
    ``rre`` ``[B]`` and, by the options, the coarse stage's errors, the
    hypotheses' matrices (``hypo_rte``, ``hypo_rre``, ``hypo_stats`` ``[B,
    K]``, ``sel``, ``cand_coarse``, ``cand_final`` ``[B, K, 4, 4]`` and each
    candidate's episode ``cand_steps``), the errors before refinement and
    the beam's matrices."""
    p = parser()
    args = p.parse_args(argv)
    maybe_initialize_distributed(args)
    dev = serve.resolve_device(args.device)
    cfg = apply_obs_overrides(build_config(args), args)
    set_seed(cfg.seed)

    test_ds = build_dataset(cfg, args, "test")
    loader = make_loader(cfg, args, test_ds,
                         batch_size=args.eval_batch_size)
    require_batches(loader)

    geo = load_geo_variables(cfg, args, dev)
    fine_geo = geo
    if args.fine_geo_ckpt:
        fine_geo = load_geo_variables(
            cfg, argparse.Namespace(geo_ckpt=args.fine_geo_ckpt), dev)
        print(f"fine stage uses geo checkpoint {args.fine_geo_ckpt}")
    agent = load_model(cfg, CMRAgent(cfg), args.agent_ckpt, "agent", "agent",
                       dev)

    if args.refine_iter and not args.iter_ckpt:
        p.error("--refine-iter needs --iter-ckpt (the cost volume that "
                "re-decodes the residual)")
    beam = [s for s in (t.strip() for t in args.refine_beam.split(",")) if s]
    if beam:
        if args.refine_rounds <= 0 or args.iter_hypotheses <= 1:
            p.error("--refine-beam needs --refine-rounds > 0 and "
                    "--iter-hypotheses > 1 (it refines candidates of the "
                    "multi-hypothesis decode)")
        specs = [(s.partition(":")[0], int(s.partition(":")[2] or 1))
                 for s in beam]
        bad = [s for s, _ in specs if s not in STATS]
        if bad:
            p.error(f"unknown --refine-beam statistics: {bad}")
        bad_rank = [(s, r) for s, r in specs
                    if not 1 <= r <= args.iter_hypotheses]
        if bad_rank:
            p.error(f"--refine-beam ranks out of 1..{args.iter_hypotheses}"
                    f": {bad_rank}")

    iter_model = None
    if args.iter_ckpt:
        iter_model = load_model(cfg, IterModel(cfg), args.iter_ckpt,
                                "itermodel", "iter", dev)
    # the JAX package's evaluation program: every refined member accepted
    # by --hypo-score, the episode's compaction in index order, every
    # statistic computed
    c2f = serve.CoarseToFine(
        cfg, geo, iter_model, agent, fine_geo=fine_geo,
        hypotheses=args.iter_hypotheses, iter_iters=args.iter_iters,
        iter_shrink=args.iter_shrink, hypo_score=args.hypo_score,
        refine_rounds=args.refine_rounds, refine_beam=beam,
        beam_score=args.beam_score or None, beam_frame=args.beam_frame,
        accept_score=args.hypo_score, rank_by_scores=False,
        refine_iter=args.refine_iter, refine_shrink=args.refine_shrink,
        need_ir=True)

    def evaluate_multi(batch):
        out = c2f(batch)
        errs = [errors(out["final"][:, j], batch, out["coarse"][:, j])
                for j in range(args.iter_hypotheses)]
        rtes = np.stack([e[0] for e in errs], axis=1)          # [B, K]
        rres = np.stack([e[1] for e in errs], axis=1)
        sel = _numpy(out["sel"]).astype(np.int64)
        arange = np.arange(len(sel))
        rec = dict(hypo_rte=rtes, hypo_rre=rres, sel=sel,
                   hypo_stats=_stat_arrays(out["stats"]),
                   cand_coarse=out["coarse"], cand_final=out["final"],
                   cand_steps=out["steps"], rte=rtes[arange, sel],
                   rre=rres[arange, sel])
        # the first branch's rebased target is P C^-1, so this is
        # pose_diff(C, P), as on the single-hypothesis path
        c0 = out["coarse"][:, 0]
        c_rte, c_rre = pose_diff(c0, apply_coarse_pose(batch, c0)["P"] @ c0)
        rec.update(c_rte=_numpy(c_rte), c_rre=_numpy(c_rre))
        if "members" not in out:
            return rec
        rec.update(pre_rte=rec["rte"], pre_rre=rec["rre"])
        b_err = []
        for m in out["members"]:
            idx = _numpy(m["idx"]).astype(np.int64)
            b_err.append(refined_errors(batch, m["rounds"],
                                        rtes[arange, idx], rres[arange, idx]))
        if "bsel" not in out:
            rec.update(rte=b_err[0][0], rre=b_err[0][1])
            return rec
        bsel = _numpy(out["bsel"]).astype(np.int64)
        rte_b = np.stack([e[0] for e in b_err], axis=1)
        rre_b = np.stack([e[1] for e in b_err], axis=1)
        rec.update(rte=rte_b[arange, bsel], rre=rre_b[arange, bsel],
                   beam_rte=rte_b, beam_rre=rre_b, beam_sel=bsel,
                   beam_stats=_stat_arrays(out["beam_stats"]))
        return rec

    def evaluate_single(batch):
        rec, coarse = {}, None
        if iter_model is None:
            state = serve.perceive(geo, batch)
        else:
            st = iter_model_state(geo(batch), batch)
            o = iter_model(st, with_loss=False)
            coarse = serve.tail_iters(iter_model, dict(
                st, pc_i=o["pc_i"], matrix_accumulated=o["matrix_accumulated"]
            ), args.iter_iters, args.iter_shrink)["matrix_accumulated"]
            batch_c = apply_coarse_pose(batch, coarse)
            c_rte, c_rre = pose_diff(coarse, batch_c["P"] @ coarse)
            rec.update(c_rte=_numpy(c_rte), c_rre=_numpy(c_rre))
            # re-perceive the near-aligned cloud with the fine-stage model
            state = serve.perceive(fine_geo, batch_c)
        final, _ = c2f.episode(state)
        rec["rte"], rec["rre"] = errors(final, batch, coarse)
        if args.refine_rounds > 0:
            if coarse is None:
                coarse = torch.eye(4, device=final.device).expand(
                    final.shape[0], 4, 4)
            total = compose_disentangled(final, coarse, batch["pc"])
            rec.update(pre_rte=rec["rte"], pre_rre=rec["rre"])
            rounds = c2f.refine(batch, total, args.hypo_score)[2]
            rec["rte"], rec["rre"] = refined_errors(batch, rounds, rec["rte"],
                                                    rec["rre"])
        return rec

    multi = iter_model is not None and args.iter_hypotheses > 1

    @torch.no_grad()
    def evaluate(batch):
        return (evaluate_multi if multi else evaluate_single)(batch)

    return args, cfg, loader, evaluate


def summarize(args, records, times) -> dict:
    """The JAX package's result dict from the per-batch records and the
    per-pair times."""
    def cat(key):
        return np.concatenate([r[key] for r in records], axis=0)

    rte_all, rre_all = cat("rte"), cat("rre")
    m = registration_metrics(rte_all, rre_all)
    first = records[0]
    if "c_rte" in first:
        m["coarse_rte_mean"] = float(np.mean(cat("c_rte")))
        m["coarse_rre_mean"] = float(np.mean(cat("c_rre")))
    if "hypo_rte" in first:
        solved_all = solved(cat("hypo_rte"), cat("hypo_rre"))     # [S, K]
        sel = cat("sel")
        m["hypo_k"] = args.iter_hypotheses
        m["hypo_score"] = args.hypo_score
        m["rr_first_hypothesis"] = float(np.mean(solved_all[:, 0]))
        m["rr_selected"] = float(np.mean(
            solved_all[np.arange(len(sel)), sel]))
        m["rr_any_hypothesis"] = float(np.mean(solved_all.any(axis=1)))
        # the recall under each statistic's selection, for offline study
        for k in first["hypo_stats"]:
            s_ = np.concatenate([r["hypo_stats"][k] for r in records]
                                ).argmax(axis=1)
            m[f"rr_sel_{k}"] = float(np.mean(
                solved_all[np.arange(len(s_)), s_]))
    if "pre_rte" in first:
        m["refine_rounds"] = args.refine_rounds
        m["rr_pre_refine"] = float(np.mean(solved(cat("pre_rte"),
                                                  cat("pre_rre"))))
        if "beam_rte" in first:
            solved_bm = solved(cat("beam_rte"), cat("beam_rre"))
            m["refine_beam"] = args.refine_beam
            m["beam_score"] = args.beam_score or args.hypo_score
            m["beam_frame"] = args.beam_frame
            m["rr_beam_any"] = float(np.mean(solved_bm.any(axis=1)))
            for k in first["beam_stats"]:
                s_ = np.concatenate([r["beam_stats"][k] for r in records]
                                    ).argmax(axis=1)
                m[f"rr_beamsel_{k}"] = float(np.mean(
                    solved_bm[np.arange(len(s_)), s_]))
    # the first batch carries the warm-up; the steady time leaves it out
    m["avg_episode_time_s"] = float(np.mean(times))
    m["avg_episode_time_steady_s"] = float(np.mean(times[1:]) if
                                           len(times) > 1 else times[0])
    m["num_samples"] = len(rte_all)
    return m


def mat_fields(records, times) -> dict:
    """The ``--save-mat`` arrays: per-sample RTE / RRE, the per-pair
    times, and the hypothesis and beam matrices."""
    dump = {"Time": np.array(times),
            "RTE": np.concatenate([r["rte"] for r in records]),
            "RRE": np.concatenate([r["rre"] for r in records])}
    for pre, key in (("hypo", "hypo"), ("beam", "beam")):
        if f"{key}_rte" in records[0]:
            dump[f"{pre}_RTE"] = np.concatenate([r[f"{key}_rte"]
                                                 for r in records])
            dump[f"{pre}_RRE"] = np.concatenate([r[f"{key}_rre"]
                                                 for r in records])
            for k in records[0][f"{key}_stats"]:
                dump[f"{pre}_{k}"] = np.concatenate(
                    [r[f"{key}_stats"][k] for r in records])
    return dump


def main(argv=None):
    args, _, loader, evaluate = prepare(argv)
    dev = serve.resolve_device(args.device)
    records, times = [], []
    for i, batch in enumerate(loader):
        batch = to_device(batch, dev)
        t0 = time.perf_counter()
        rec = evaluate(batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) / batch["pc"].shape[0])
        records.append({k: v for k, v in rec.items()
                        if not k.startswith("cand_")})
        if args.max_batches and i + 1 >= args.max_batches:
            break
    m = summarize(args, records, times)
    if args.save_mat:
        import scipy.io as scio
        scio.savemat(args.save_mat, mat_fields(records, times))
    print(json.dumps(m, indent=2))
    return m


if __name__ == "__main__":
    main()
