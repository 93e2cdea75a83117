"""Learning-convergence demonstration on synthetic data (counterpart of
the JAX package's ``examples/convergence_demo.py``, the program that
trained the committed ``runs_r4`` trees).

Trains the geo model, then the agent by behaviour cloning, and shows:

1. geo loss decreasing,
2. the trained agent reducing pose error vs the untrained agent,
3. the expert's 10-step error as the floor.

Runs on the card; ``--device cpu`` runs it on the CPU with the kernels'
plain versions. No dataset on disk is needed::

    python -m cmr_agent_tpu_torch.examples.convergence_demo \\
        [--geo-steps N] [--agent-steps M]

``--full`` switches from the tiny config to full KITTI scale (40960
points, 160x512 images, bf16 activations), the scale of the convergence
evidence in docs/CONVERGENCE.md. ``--save-geo`` / ``--save-agent`` write
stepless model snapshots (:func:`..train.checkpoint.save_model_snapshot`)
that the port's CLIs load behind their checkpoint flags;
``--load-geo`` / ``--load-agent`` take those, the port's train
checkpoints, and the committed trees through their weight exports
(``--load-geo runs_r4/geo_45``).

The JAX demo's closures are module functions here, so that tests can call
them: :func:`make_pool`, :func:`geo_r_scale`, :func:`cur_scale`,
:func:`geo_holdout_overlap`, :func:`rollout_det`, :func:`eval_agent`,
:func:`eval_agreement`, :func:`eval_expert` and :func:`select_score`.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..cli.common import apply_obs_overrides, to_device
from ..config import Config, kitti_config, tiny_config
from ..data import DataLoader, SyntheticDataset, collate
from ..env.buffer import TrajectoryBuffer
from ..env.environment import apply_action, expert_action, init_poses
from ..env.episode import run_episode, step_tables
from ..models.multi_head import matching_inlier_ratio
from ..ops.geometry import pose_diff, to_disentangled
from ..serve import resolve_device
from ..train.checkpoint import restore_state_dict, save_model_snapshot
from ..train.optim import make_lr_schedule
from ..train.train_agent import (create_agent_state, episode_poses,
                                 episode_state, make_ppo_update_step,
                                 make_rollout_fn, make_val_episode_fn)
from ..train.train_geo import (create_geo_state, make_geo_forward,
                               make_geo_train_step, wrap_oracle_overlap)

Batch = Dict[str, torch.Tensor]

# Per-sample amplitude mixture, the reference's own (dead-code) design:
# NuScenesDataset.py:64-65 defines T_list=[0.5..10] m and R_list=[0.9..180]
# deg for random_RT_amplitude: every training sample draws its own
# difficulty, so easy samples anchor BC while hard ones feed the
# full-protocol signal from step 0. As fractions of the full amplitude:
T_MIX = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
R_MIX = (0.005, 0.01, 0.02, 0.04, 0.08, 0.16, 0.32, 0.64, 1.0)
# the held-out validation pool's seed: disjoint from the training pools'
VAL_SEED = 7919


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--geo-steps", type=int, default=40)
    p.add_argument("--agent-steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--full", action="store_true",
                   help="full KITTI scale (bf16) instead of the tiny config")
    p.add_argument("--embed-dim", type=int, default=0,
                   help="override cfg.embed_dim (0 keeps the config "
                        "default). Capacity probe for the CONVERGENCE.md "
                        "section-11 finding that the reference-scale "
                        "64-channel encoder cannot fit synthetic overlap "
                        "localisation at the full protocol: e.g. "
                        "--embed-dim 128 doubles every feature width "
                        "(image/point branches, fusion, heads) — all "
                        "shapes derive from the config, nothing else to "
                        "change")
    p.add_argument("--mlp-dim", type=int, default=0,
                   help="override cfg.mlp_dim (ViT MLP width); 0 keeps "
                        "the config default. Usually scaled with "
                        "--embed-dim (reference ratio is 16x embed_dim)")
    p.add_argument("--t-amp", type=float, default=None,
                   help="translation perturbation amplitude (m); the KITTI "
                        "default +-10 m throws most of a random synthetic "
                        "cloud out of the frustum, starving the 2-D "
                        "observation — a reduced amplitude keeps the demo's "
                        "imitation problem observable")
    p.add_argument("--r-amp", type=float, default=None,
                   help="yaw perturbation amplitude (rad)")
    p.add_argument("--scene", default="random",
                   choices=["random", "structured"],
                   help="'structured' (persistent ground+boxes + rendered "
                        "image) keeps the full reference +-10 m/+-pi "
                        "protocol observable — use it with NO --t-amp/"
                        "--r-amp reduction for the full-amplitude run")
    p.add_argument("--pool-size", type=int, default=16,
                   help="scenes per training pool")
    p.add_argument("--refresh-every", type=int, default=0,
                   help="regenerate the training pool (fresh scenes AND "
                        "fresh perturbations via dataset.set_epoch) every N "
                        "agent steps; 0 keeps the historical fixed-pool "
                        "behaviour. At the full +-10 m/+-pi protocol a "
                        "frozen 16-perturbation pool is far too sparse to "
                        "learn from (round-3 run: agreement 24%% but RTE "
                        "diverged); refreshing makes the perturbation "
                        "space effectively unlimited, like a real dataset")
    p.add_argument("--geo-refresh-every", type=int, default=0,
                   help="same for geo training steps; 0 = fixed pool")
    p.add_argument("--geo-curriculum", type=float, default=0.0,
                   help="amplitude curriculum for the GEO stage: the "
                        "training pool's yaw amplitude ramps linearly from "
                        "--geo-r-start to the full configured amplitude "
                        "over this fraction of geo steps (translation "
                        "stays at full amplitude throughout; the held-out "
                        "pool always draws at full amplitude). Motivated "
                        "by docs/CONVERGENCE.md section 13: held-out "
                        "overlap generalisation turns on at +-45 deg but "
                        "is blind cold at +-90 deg within the budget — "
                        "this tests whether warm low-amplitude perception "
                        "extends the frontier. Requires "
                        "--geo-refresh-every; 0 disables")
    p.add_argument("--geo-r-start", type=float, default=0.7854,
                   help="starting yaw amplitude (rad) for "
                        "--geo-curriculum (default pi/4, the measured "
                        "turn-on point of the amplitude-frontier study)")
    p.add_argument("--geo-select-ir", action="store_true",
                   help="select the best geo snapshot by held-out matching "
                        "inlier ratio instead of overlap accuracy — for "
                        "runs whose consumer is the cost volume (which "
                        "matches circle-loss features under explicit "
                        "hypothesis warps) rather than the overlap head")
    p.add_argument("--geo-warm-start", action="store_true",
                   help="with --load-geo: continue stage-1 training from "
                        "the checkpoint instead of skipping it (fresh "
                        "optimizer state) — a two-phase curriculum across "
                        "separate runs, e.g. train at +-45 deg, then warm-"
                        "start a +-90 deg run from the saved snapshot")
    p.add_argument("--curriculum", type=float, default=0.0,
                   help="fraction of agent steps over which the TRAINING "
                        "perturbation amplitude ramps 0.15->1.0 of full "
                        "(validation always runs at full amplitude). "
                        "Standard imitation-learning trick: early pools "
                        "keep the policy near states where BC labels are "
                        "informative; 0 disables. Requires --refresh-every")
    p.add_argument("--amp-mixture", action="store_true",
                   help="per-sample amplitude mixture instead of a time "
                        "curriculum: every pool sample draws its own "
                        "(t, r) amplitude from the reference's T_list/"
                        "R_list design (NuScenesDataset.py:64-65, dead "
                        "upstream) — easy samples anchor BC while "
                        "full-amplitude ones train the hard regime from "
                        "step 0. Applies to geo and agent pools; "
                        "overrides --curriculum; requires --refresh-every")
    p.add_argument("--w-entropy", type=float, default=None,
                   help="override cfg.w_entropy (the PPO entropy bonus): "
                        "at +-pi yaw the deterministic-argmax policy can "
                        "fall into a rotation-frozen local optimum (always "
                        "the 0-degree step scores a constant val RRE equal "
                        "to the initial error); a larger entropy bonus "
                        "keeps rotation exploration alive long enough for "
                        "the PPO term to reward committed rotation")
    p.add_argument("--expert-beta-frac", type=float, default=0.0,
                   help="DAgger scheduled sampling: rollouts take the "
                        "EXPERT action with probability beta, annealed "
                        "1->0 over this fraction of agent steps. The "
                        "reference's pure on-policy BC (beta=0) parks "
                        "early rollouts in far states whose labels are "
                        "all saturated max-steps — at the full +-10 m/"
                        "+-pi protocol it never recovers (round-3 runs A/"
                        "B). beta-annealing visits the expert's own "
                        "state distribution first, then hands over")
    p.add_argument("--expert-beta-floor", type=float, default=0.0,
                   help="lower bound for the annealed expert beta: keep "
                        "this fraction of expert actions in rollouts for "
                        "the whole run, so the buffer never loses the "
                        "expert's state distribution (round-3 run D: full "
                        "anneal to 0 let the on-policy phase re-collapse "
                        "onto the max-step action marginal)")
    p.add_argument("--alpha", type=float, default=None,
                   help="override cfg.alpha (PPO weight vs BC); 0 = pure "
                        "behaviour cloning")
    p.add_argument("--pose-aware", action="store_true",
                   help="pose-aware 3-D observation (Config."
                        "pose_aware_observation): the point branch sees the "
                        "cloud under the current estimate, so consecutive "
                        "observations differ even when a large yaw error "
                        "empties the raster — the repeat-action translation "
                        "runaway of runs D/E cannot occur")
    p.add_argument("--obs-bearing", action="store_true",
                   help="append the overlap-sector bearing (unit x,z of "
                        "its centroid under the current estimate) as two "
                        "3-D observation channels — the diagnose_agent "
                        "oracle shows yaw direction is an ~0.88-accurate "
                        "function of this statistic while trained "
                        "policies guess it (docs/CONVERGENCE.md sec. 9)")
    p.add_argument("--lr", type=float, default=None,
                   help="override cfg.lr for BOTH stages")
    p.add_argument("--lr-epoch-steps", type=int, default=0,
                   help="pace the agent's StepLR schedule: optimizer steps "
                        "per 'epoch' (decay x0.6 every step_size=4 "
                        "epochs). The historical default (1000) decays "
                        "every ~400 demo agent steps — each agent step "
                        "runs ~K*B/ppo_batch optimizer updates — so runs "
                        "beyond ~4000 steps train at lr < 1e-5: the "
                        "round-3 A-F plateaus were partly a dead learning "
                        "rate, not a learnability ceiling. 0 keeps the "
                        "historical default; pass e.g. total_updates/16 "
                        "to spread the reference's 16 decays (64 epochs / "
                        "step_size 4, KittiConfig.py:35-38) over the run")
    p.add_argument("--load-agent", default="",
                   help="agent checkpoint to warm-start from (a "
                        "--save-agent snapshot, a port train checkpoint or "
                        "a weight export or the Orbax tree it came from; "
                        "optimizer state starts fresh)")
    p.add_argument("--save-geo", default="",
                   help="directory to save the stage-1 geo model's "
                        "snapshot to (the full-scale geo stage takes many "
                        "minutes; saving it lets ablation runs share it)")
    p.add_argument("--load-geo", default="",
                   help="geo checkpoint to load, skipping stage 1 (a "
                        "--save-geo snapshot, a port train checkpoint or a "
                        "weight export or the Orbax tree it came from; "
                        "must match the config's scale)")
    p.add_argument("--save-agent", default="",
                   help="directory to save the best-validation agent "
                        "snapshot to (parameters + BatchNorm statistics), "
                        "for later evaluation/visualisation")
    p.add_argument("--val-every", type=int, default=0,
                   help="validate (and consider a best snapshot) every N "
                        "agent steps; 0 = max(10, agent_steps/8)")
    p.add_argument("--aux-head", action="store_true",
                   help="feed the bearing statistic straight into the "
                        "policy/value heads (Config.policy_aux_state; "
                        "implies --obs-bearing)")
    p.add_argument("--bearing-init", action="store_true",
                   help="coarse-to-fine: start every episode (rollout and "
                        "eval) from the bearing-aligned yaw "
                        "(Config.bearing_init)")
    p.add_argument("--oracle-overlap", action="store_true",
                   help="ABLATION: feed the agent ground-truth overlap "
                        "flags instead of the geo head's predictions, "
                        "which memorise the training scenes "
                        "(docs/CONVERGENCE.md section 11); results are "
                        "labelled oracle-perception")
    p.add_argument("--select-median", action="store_true",
                   help="pick the best-validation snapshot by (solved "
                        "scenes, median RRE + 2*median RTE) instead of the "
                        "outlier-dominated mean score (CONVERGENCE.md "
                        "section 9)")
    p.add_argument("--stop-file", default="",
                   help="graceful stop: when this file appears, finish the "
                        "current step, run the final evaluation and save "
                        "snapshots — the safe way to cut a run on the card "
                        "short without losing them")
    p.add_argument("--val-size", type=int, default=0,
                   help="held-out validation scenes at FULL amplitude "
                        "(fixed seed, disjoint from training); 0 = "
                        "historical behaviour (validate on the train pool)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    p = parser()
    args = p.parse_args(argv)
    if args.select_median and not args.val_size:
        # without a held-out pool, eval_agent scores the *train* pool,
        # which --refresh-every/--curriculum regenerate at varying
        # difficulty — solved counts across pools of different difficulty
        # are not comparable, so the lexicographic selection would freeze
        # on the easiest pool
        p.error("--select-median requires --val-size (a fixed held-out "
                "validation pool)")
    if args.geo_curriculum > 0 and not args.geo_refresh_every:
        # the curriculum acts through pool regeneration; without refresh
        # the initial reduced-amplitude pool would silently train forever
        p.error("--geo-curriculum requires --geo-refresh-every")
    if args.geo_warm_start and not args.load_geo:
        p.error("--geo-warm-start requires --load-geo (the snapshot to "
                "continue from)")
    return args


def build_config(args) -> Tuple[Config, tuple]:
    """The demo's config (``--full``: KITTI width in bf16, else the tiny
    config) with the shared flag mapping applied, and the host ops its
    pools use (the native FPS and 1-NN at full scale, the numpy ones
    otherwise)."""
    host_ops = (None, None)
    if args.full:
        from ..native import get_fast_host_ops
        cfg = kitti_config(compute_dtype="bfloat16",
                           train_batch_size=args.batch_size,
                           num_trajectory=2, ppo_batch_size=8)
        host_ops = get_fast_host_ops()
    else:
        cfg = tiny_config(train_batch_size=args.batch_size,
                          num_trajectory=2, ppo_batch_size=8)
    # one shared flag->config mapping for every CLI/tool (cli.common)
    return apply_obs_overrides(cfg, args), host_ops


def scaled_cfg(cfg: Config, scale: float,
               r_scale: Optional[float] = None) -> Config:
    """``cfg`` with the training perturbation amplitudes scaled
    (curriculum / mixture). ``r_scale`` defaults to ``scale``."""
    rs = scale if r_scale is None else r_scale
    if scale >= 1.0 and rs >= 1.0:
        return cfg
    return dataclasses.replace(
        cfg,
        p_tx_amplitude=cfg.p_tx_amplitude * scale,
        p_ty_amplitude=cfg.p_ty_amplitude * scale,
        p_tz_amplitude=cfg.p_tz_amplitude * scale,
        p_rx_amplitude=cfg.p_rx_amplitude * rs,
        p_ry_amplitude=cfg.p_ry_amplitude * rs,
        p_rz_amplitude=cfg.p_rz_amplitude * rs)


def _samples(sample, length: int) -> list:
    """``[sample(i) for i in range(length)]``, the scenes made in threads
    (each from its own seed, so the order of work changes no draw; the
    native FPS / 1-NN and numpy release the interpreter lock)."""
    workers = max(1, min(length, os.cpu_count() or 1, 8))
    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(sample, range(length)))


def make_pool(cfg: Config, args, length: int, *, seed: int, epoch: int = 0,
              scale: float = 1.0, r_scale: Optional[float] = None,
              shuffle: bool = True, mixture: bool = False,
              host_ops=(None, None), device="cpu") -> List[Batch]:
    """A pool of batches of ``args.batch_size`` on ``device``: fresh scenes
    AND fresh perturbations per (seed, epoch), the JAX demo's recipe
    draw for draw. With ``mixture`` every sample draws its own (t, r)
    amplitude pair from T_MIX x R_MIX (mixed WITHIN each batch).
    ``r_scale`` decouples the yaw amplitude from ``scale`` (the geo
    curriculum keeps translation at full amplitude while ramping yaw)."""
    fps_fn, nn_fn = host_ops
    bs = args.batch_size

    def dataset(c: Config) -> SyntheticDataset:
        ds = SyntheticDataset(c, length=length, seed=seed, fps_fn=fps_fn,
                              nn_fn=nn_fn, scene=args.scene)
        ds.set_epoch(epoch)
        return ds

    if not mixture:
        samples = _samples(dataset(scaled_cfg(cfg, scale, r_scale))
                           .__getitem__, length)
        loader = DataLoader(samples, bs, shuffle=shuffle, num_workers=0,
                            seed=seed + epoch)
        return [to_device(b, device) for b in loader]
    rng = np.random.default_rng((seed, epoch, 77))
    amps = [(float(rng.choice(T_MIX)), float(rng.choice(R_MIX)))
            for _ in range(length)]
    samples = _samples(lambda i: dataset(scaled_cfg(cfg, *amps[i]))[i],
                       length)
    order = rng.permutation(length) if shuffle else np.arange(length)
    return [to_device(collate([samples[j] for j in order[s:s + bs]]), device)
            for s in range(0, length - bs + 1, bs)]


def geo_r_scale(cfg: Config, args, i: int) -> float:
    """Geo-curriculum yaw-amplitude scale at geo step ``i``: linear ramp
    from --geo-r-start to the full configured amplitude over
    --geo-curriculum * geo_steps, then flat at 1.0."""
    if args.geo_curriculum <= 0:
        return 1.0
    target = max(cfg.p_ry_amplitude, 1e-9)
    start = min(1.0, args.geo_r_start / target)
    ramp = max(1.0, args.geo_curriculum * args.geo_steps)
    return min(1.0, start + (1.0 - start) * i / ramp)


def cur_scale(args, i: int) -> float:
    """Curriculum amplitude scale at agent step ``i`` (0.15 -> 1.0)."""
    if args.curriculum <= 0:
        return 1.0
    ramp = max(1.0, args.curriculum * args.agent_steps)
    return min(1.0, 0.15 + 0.85 * i / ramp)


def expert_beta(args, i: int) -> Optional[float]:
    """The rollout's DAgger beta at agent step ``i``: annealed 1 -> 0 over
    --expert-beta-frac of the run, never below --expert-beta-floor (the
    floor alone: constant mixing from step 0); None without either."""
    if args.expert_beta_frac <= 0 and args.expert_beta_floor <= 0:
        return None
    if args.expert_beta_frac > 0:
        ramp = args.expert_beta_frac * args.agent_steps
        annealed = 1.0 - i / max(1.0, ramp)
    else:
        annealed = 0.0
    return max(args.expert_beta_floor, annealed)


def geo_holdout_overlap(cfg: Config, raw_fwd, model,
                        val_batches: Optional[List[Batch]]):
    """Held-out per-point overlap accuracy, prediction rate, gt rate and
    matching inlier ratio (IR), or None without a held-out pool.

    The training-pool accuracy the stage prints at the end is measured on
    scenes the model trains on; run J's geo read 0.991 there while
    collapsing to 1.8%-firing majority-class predictions on the held-out
    pool (below the ~0.87 majority baseline) — which starves every
    downstream signal (raster, overlap flags, bearing). This metric makes
    that visible in-run (docs/CONVERGENCE.md section 11). The IR is the
    circle-loss features' quality, independent of the overlap head
    (Test_Geo protocol, <= 3 px)."""
    if val_batches is None:
        return None
    accs, rates, gts, irs = [], [], [], []
    for vb in val_batches:
        out = raw_fwd(model, vb)
        pred = out["pc_overlap_pred"].cpu().numpy()
        mask = vb["pc_mask"].bool()
        gt = mask.cpu().numpy()
        accs.append((pred == gt).mean())
        rates.append(pred.mean())
        gts.append(gt.mean())
        irs.append(float(np.mean([
            float(matching_inlier_ratio(
                out["pc_geo_feat"][b], out["img_geo_feat"][b], mask[b],
                vb["point_xy_float_all"][b], cfg.image_w, cfg.image_h))
            for b in range(mask.shape[0])])))
    return (float(np.mean(accs)), float(np.mean(rates)),
            float(np.mean(gts)), float(np.mean(irs)))


def rollout_det(cfg: Config, agent_state, geo_out, batch: Batch
                ) -> Dict[str, torch.Tensor]:
    """A deterministic episode with the expert's labels (from the bearing
    yaw with ``cfg.bearing_init``): its trajectory."""
    agent = agent_state.agent.eval()
    state = episode_state(geo_out, batch)
    pose_src, pose_tgt = episode_poses(cfg, state)
    with torch.no_grad():
        _, _, traj = run_episode(agent, state, pose_src, cfg,
                                 pose_target=pose_tgt, deterministic=True,
                                 with_expert=True, collect_trajectory=True)
    return traj


def episode_stats(rte_all, rre_all, detail: bool = False):
    """``(mean RTE, mean RRE, stats)`` of a validation's per-sample
    errors; ``stats`` holds the medians, the solved count (RTE < 5 m and
    RRE < 10 deg) and the sample count."""
    rte_a, rre_a = np.asarray(rte_all), np.asarray(rre_all)
    stats = {"median_rte": float(np.median(rte_a)),
             "median_rre": float(np.median(rre_a)),
             "solved": int(((rre_a < 10.0) & (rte_a < 5.0)).sum()),
             "n": len(rte_a)}
    if detail:
        # mean RRE is dominated by wrap-region stragglers (a single
        # yaw~180 sample reads ~360 on the euler-sum metric); median +
        # solved count tell "half solved" apart from "uniformly stuck"
        print(f"[val-detail] solved(RR thresholds) "
              f"{stats['solved']}/{stats['n']}"
              f"  median RTE {stats['median_rte']:.2f}"
              f"  median RRE {stats['median_rre']:.2f}", flush=True)
    return float(np.mean(rte_all)), float(np.mean(rre_all)), stats


def eval_agent(val, fwd, geo, agent_state, batches: List[Batch],
               detail: bool = False):
    """The deterministic validation episode (``val``, a
    :func:`..train.train_agent.make_val_episode_fn`) over ``batches`` on
    the geo outputs ``fwd(geo, batch)``: :func:`episode_stats`."""
    rte_all, rre_all = [], []
    for batch in batches:
        _, rte, rre = val(agent_state, fwd(geo, batch), batch)
        rte_all += rte.tolist()
        rre_all += rre.tolist()
    return episode_stats(rte_all, rre_all, detail)


def select_score(v_rte: float, v_rre: float, stats: dict,
                 select_median: bool, best_score: tuple) -> tuple:
    """A validation's snapshot score (lower is better). With
    ``select_median`` lexicographic: maximise solved scenes (the actual RR
    target), tie-break by the outlier-robust median score; run K's
    mean-based selection picked a step-1199 snapshot over step-4199/4799
    ones with 4x the expert agreement because the mean is dominated by
    the wrap-region stragglers (docs/CONVERGENCE.md section 9). A diverged
    validation (NaN) scores ``best_score``, so it never wins: with tuple
    scores (0, nan) < (inf, inf) is True on the constant first element."""
    if select_median:
        score = (-stats["solved"],
                 stats["median_rre"] + 2.0 * stats["median_rte"])
    else:
        score = (0, v_rre + 2.0 * v_rte)
    if not all(np.isfinite(s) for s in score):
        score = best_score
    return score


def head_agreement(traj) -> Tuple[float, float]:
    """Per-head agreement with the expert along a trajectory: splits
    "policy can't infer rotation" from "can't infer translation"."""
    return tuple(float((traj[f"action_{k}"] == traj[f"expert_action_{k}"])
                       .float().mean()) for k in ("r", "t"))


def eval_agreement(cfg: Config, fwd, geo, agent_state,
                   batches: List[Batch]) -> float:
    """Deterministic-policy agreement with the expert along its own
    trajectory (what behaviour cloning optimises)."""
    agree, total = 0, 0
    for batch in batches:
        traj = rollout_det(cfg, agent_state, fwd(geo, batch), batch)
        for k in ("r", "t"):
            a, e = traj[f"action_{k}"], traj[f"expert_action_{k}"]
            agree += int((a == e).sum())
            total += a.numel()
    return agree / total


def eval_expert(cfg: Config, batches: List[Batch]) -> Tuple[float, float]:
    """Mean RTE and RRE of ``cfg.action_num`` expert steps from the
    identity: the floor of the discrete action space."""
    r_steps, t_steps = step_tables(cfg, batches[0]["P"].device)
    rte_all, rre_all = [], []
    for batch in batches:
        pose, tgt = init_poses(batch)
        tgt = to_disentangled(tgt, batch["pc"])
        for _ in range(cfg.action_num):
            ar, at = expert_action(pose, tgt, r_steps, t_steps, cfg.is_6_dof)
            pose = apply_action(ar, at, pose, r_steps, t_steps, cfg.is_6_dof)
        rte, rre = pose_diff(pose, tgt)
        rte_all += rte.tolist()
        rre_all += rre.tolist()
    return float(np.mean(rte_all)), float(np.mean(rre_all))


def _state_copy(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Parameters AND BatchNorm running statistics, copied: the eval
    behaviour depends on both."""
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg, host_ops = build_config(args)

    def pool(length, **kw):
        return make_pool(cfg, args, length, host_ops=host_ops, device=dev,
                         **kw)

    # ---- stage 1: geo model ----
    batches = pool(args.pool_size, seed=0, mixture=args.amp_mixture,
                   r_scale=geo_r_scale(cfg, args, 0))
    # held-out validation pool: full amplitude always, disjoint seed
    val_batches = (pool(args.val_size, seed=VAL_SEED, shuffle=False)
                   if args.val_size > 0 else None)
    geo_state = create_geo_state(cfg, dev, seed=0)
    geo = geo_state.model
    geo_step = make_geo_train_step(cfg)
    raw_fwd = make_geo_forward(cfg)
    # oracle-perception ablation (shared wrapper, section 11); results
    # produced under --oracle-overlap are labelled as an ablation
    fwd = wrap_oracle_overlap(raw_fwd) if args.oracle_overlap else raw_fwd

    def holdout():
        return geo_holdout_overlap(cfg, raw_fwd, geo, val_batches)

    t0 = time.time()
    losses: List[float] = []
    if args.load_geo:
        geo.load_state_dict(restore_state_dict(args.load_geo, cfg,
                                               "multihead"))
        losses = [float("nan")]
        print(f"[geo] loaded from {args.load_geo}"
              + ("" if args.geo_warm_start else ", skipping stage 1"),
              flush=True)
    if not args.load_geo or args.geo_warm_start:
        if args.geo_warm_start:
            losses = []
        best_geo_acc, metrics = -1.0, None
        for i in range(args.geo_steps):
            if args.stop_file and os.path.exists(args.stop_file):
                print(f"[geo] stop-file {args.stop_file} found at step {i}",
                      flush=True)
                break
            if (args.geo_refresh_every and i > 0
                    and i % args.geo_refresh_every == 0):
                batches = pool(args.pool_size, seed=0,
                               epoch=i // args.geo_refresh_every,
                               mixture=args.amp_mixture,
                               r_scale=geo_r_scale(cfg, args, i))
            metrics = geo_step(geo_state, batches[i % len(batches)],
                               torch.Generator(device=dev).manual_seed(i))
            losses.append(float(metrics["loss"]))
            if i % 10 == 0:
                print(f"[geo] step {i:3d} loss {losses[-1]:.4f}", flush=True)
            if val_batches is not None and i > 0 and \
                    i % max(100, args.geo_steps // 20) == 0:
                acc, rate, gtr, ir = holdout()
                # keep the BEST held-out snapshot, saved incrementally
                # (like the agent stage): the held-out accuracy
                # oscillates ~1pp between checkpoints, so the final
                # state can be a weak point (run P1: final 0.884 with
                # pred-rate 0.025 vs best 0.895 with 0.134)
                tag = ""
                sel = ir if args.geo_select_ir else acc
                if args.save_geo and sel > best_geo_acc:
                    best_geo_acc = sel
                    save_model_snapshot(args.save_geo, geo.state_dict())
                    tag = "  *saved*"
                amp = (f" train-r-amp "
                       f"{geo_r_scale(cfg, args, i) * cfg.p_ry_amplitude:.3f}"
                       if args.geo_curriculum > 0 else "")
                print(f"[geo-val] step {i:3d} pc-acc {acc:.3f} "
                      f"pred-rate {rate:.3f} gt-rate {gtr:.3f} "
                      f"IR {ir:.3f}{amp}{tag}", flush=True)
        print(f"[geo] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({time.time()-t0:.0f}s)")
        if args.geo_curriculum <= 0 and not args.geo_warm_start:
            # with a curriculum the pool difficulty GROWS over the run and
            # a warm start begins already-descended, so first-vs-last loss
            # is not a monotone descent check in either mode
            assert losses[-1] < losses[0]
        if metrics is not None:
            print(f"[geo] overlap acc: "
                  f"pc {float(metrics['pc_overlap_accuracy']):.3f}"
                  f" img {float(metrics['img_overlap_accuracy']):.3f}",
                  flush=True)
        if args.save_geo:
            final_hold = holdout()
            sel_idx = 3 if args.geo_select_ir else 0
            if final_hold is None or final_hold[sel_idx] > best_geo_acc:
                save_model_snapshot(args.save_geo, geo.state_dict())
                print(f"[geo] saved to {args.save_geo}", flush=True)
            else:
                # reload the best snapshot so the in-process agent stage
                # (and the returned holdout numbers) use what was saved
                geo.load_state_dict(restore_state_dict(args.save_geo, cfg,
                                                       "multihead"))
                print(f"[geo] kept best held-out snapshot in "
                      f"{args.save_geo} "
                      f"({'IR' if args.geo_select_ir else 'acc'} "
                      f"{best_geo_acc:.3f} > final "
                      f"{final_hold[sel_idx]:.3f}) and reloaded it",
                      flush=True)

    hold = holdout()
    if hold is not None:
        print(f"[geo-val] final pc-acc {hold[0]:.3f} "
              f"pred-rate {hold[1]:.3f} gt-rate {hold[2]:.3f} "
              f"IR {hold[3]:.3f}", flush=True)
    if args.agent_steps == 0:
        # geo-only run (e.g. the held-out-overlap diversity experiments)
        return {"geo_losses": losses, "geo_holdout": hold}

    # ---- stage 2: agent by behaviour cloning ----
    agent_state = create_agent_state(
        cfg, dev, seed=1, steps_per_epoch=args.lr_epoch_steps or 1000)
    # a copy: the updates change the agent in place
    untrained = dataclasses.replace(agent_state,
                                    agent=copy.deepcopy(agent_state.agent))
    if args.load_agent:
        agent_state.agent.load_state_dict(restore_state_dict(
            args.load_agent, cfg, "agent"))
        print(f"[agent] warm-started from {args.load_agent}", flush=True)

    # Decay cadence up front: each agent step runs ~B*K/ppo_batch optimizer
    # updates, so StepLR (step_size epochs of lr_epoch_steps updates) decays
    # every step_size*lr_epoch_steps/updates_per_step agent steps. Runs A-F
    # silently trained at lr <= 1.3e-4 after step 2000 because nothing
    # printed this (docs/CONVERGENCE.md section 4).
    upd_per_step = max(1, (args.batch_size * cfg.action_num)
                       // cfg.ppo_batch_size)
    eff_epoch = args.lr_epoch_steps or 1000
    print(f"[agent] lr {cfg.lr:g}, x{cfg.scheduler_gamma:g} every "
          f"{cfg.step_size * eff_epoch // upd_per_step} agent steps "
          f"(~{upd_per_step} updates/step, lr-epoch-steps {eff_epoch})",
          flush=True)

    rollout = make_rollout_fn(cfg)
    update = make_ppo_update_step(cfg)
    val = make_val_episode_fn(cfg)
    schedule = make_lr_schedule(cfg, eff_epoch)
    buffer = TrajectoryBuffer(cfg.gamma, cfg.gae_lambda)
    rng = np.random.default_rng(0)

    def eval_pool():
        # the held-out pool, or without one the current training pool
        return val_batches if val_batches is not None else batches

    # Best-validation selection over the run, like the reference's
    # save-on-improvement protocol (Train_Agent.py:170-212): on-policy BC
    # is noisy late in training, so the returned agent is the best
    # val snapshot, not the final step. Score weights RRE:RTE as the
    # registration-recall thresholds do (10 deg : 5 m).
    val_every = args.val_every or max(10, args.agent_steps // 8)
    best_score, best_snap = (np.inf, np.inf), None

    t0 = time.time()
    bc_first = bc_last = None
    for i in range(args.agent_steps):
        if args.stop_file and os.path.exists(args.stop_file):
            print(f"[agent] stop-file {args.stop_file} found at step {i}",
                  flush=True)
            break
        if args.refresh_every and i % args.refresh_every == 0:
            # agent-stage pools: own seed stream (disjoint from geo's),
            # fresh scenes + perturbations, curriculum- or mixture-scaled
            batches = pool(args.pool_size, seed=1000,
                           epoch=i // args.refresh_every,
                           scale=cur_scale(args, i),
                           mixture=args.amp_mixture)
        batch = batches[i % len(batches)]
        traj, _, _ = rollout(agent_state, fwd(geo, batch), batch,
                             torch.Generator(device=dev).manual_seed(i),
                             expert_beta(args, i))
        buffer.add(traj)
        if len(buffer) == cfg.num_trajectory:
            samples = buffer.samples()
            n = samples["state_2d"].shape[0]
            order = rng.permutation(n)
            for s in range(0, n - cfg.ppo_batch_size + 1, cfg.ppo_batch_size):
                rows = torch.as_tensor(order[s:s + cfg.ppo_batch_size],
                                       device=dev)
                mb = {k: v.index_select(0, rows) for k, v in samples.items()}
                bc_last = float(update(agent_state, mb)["bc_loss"])
                if bc_first is None:
                    bc_first = bc_last
            buffer.clear()
            print(f"[agent] step {i:3d} bc_loss {bc_last:.4f}", flush=True)
        if (i + 1) % val_every == 0 or i == args.agent_steps - 1:
            v_rte, v_rre, v_stats = eval_agent(val, fwd, geo, agent_state,
                                               eval_pool(), detail=True)
            score = select_score(v_rte, v_rre, v_stats, args.select_median,
                                 best_score)
            mark = " *" if score < best_score else ""
            # per-head expert agreement on one val batch: splits "policy
            # can't infer rotation" from "can't infer translation" (run D
            # diverged in translation only; this makes that visible live)
            vb = eval_pool()[0]
            ag_r, ag_t = head_agreement(rollout_det(cfg, agent_state,
                                                    fwd(geo, vb), vb))
            # current lr from the schedule at the optimizer-update counter:
            # the dead-lr defect behind runs A-F was invisible because no
            # per-run log line carried it (docs/CONVERGENCE.md section 4)
            cur_lr = float(schedule(agent_state.step))
            print(f"[agent] step {i:3d} val RTE {v_rte:.3f} RRE {v_rre:.3f}"
                  f" agree r {ag_r:.2f} t {ag_t:.2f}"
                  f" lr {cur_lr:.2e}{mark}", flush=True)
            if score < best_score:
                best_score = score
                best_snap = _state_copy(agent_state.agent)
                if args.save_agent:
                    # persist on every improvement: a multi-hour run that
                    # dies late must not lose its best snapshot to the
                    # end-of-run save
                    save_model_snapshot(args.save_agent, best_snap)
    if bc_first is not None:
        print(f"[agent] bc_loss {bc_first:.4f} -> {bc_last:.4f} "
              f"({time.time()-t0:.0f}s)")
    if best_snap is not None:
        agent_state.agent.load_state_dict(best_snap)
    if args.save_agent:
        save_model_snapshot(args.save_agent,
                            _state_copy(agent_state.agent))
        print(f"[agent] best snapshot saved to {args.save_agent}",
              flush=True)

    # ---- evaluation ----
    u_agree = eval_agreement(cfg, fwd, geo, untrained, eval_pool())
    t_agree = eval_agreement(cfg, fwd, geo, agent_state, eval_pool())
    u_rte, u_rre, _ = eval_agent(val, fwd, geo, untrained, eval_pool(),
                                 detail=True)
    t_rte, t_rre, _ = eval_agent(val, fwd, geo, agent_state, eval_pool(),
                                 detail=True)
    e_rte, e_rre = eval_expert(cfg, eval_pool())
    print("\n                 expert-agreement   RTE (m)   RRE (deg)")
    print(f"untrained agent        {u_agree:6.1%}   {u_rte:8.3f} {u_rre:10.3f}")
    print(f"trained agent          {t_agree:6.1%}   {t_rte:8.3f} {t_rre:10.3f}")
    print(f"expert (floor)              -   {e_rte:8.3f} {e_rre:10.3f}")
    assert t_agree > u_agree, "BC should raise expert-action agreement"
    return {"agreement": (u_agree, t_agree),
            "untrained": (u_rte, u_rre), "trained": (t_rte, t_rre),
            "expert": (e_rte, e_rre), "geo_losses": losses,
            "bc": (bc_first, bc_last)}


if __name__ == "__main__":
    main()
