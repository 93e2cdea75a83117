"""Serving entry points: the PyTorch counterpart of ``bench.py``'s
``build_workload`` (KITTI-shaped synthetic batch, random weights from a
seed, geo forward + deterministic refinement episode), and of the
coarse-to-fine pipeline that the JAX package's
``train/export.py:export_composed_pipeline`` serves as one program
(:func:`composed_pipeline`, :func:`build_composed_workload`).

Runs on the card unless the caller passes ``device="cpu"``; asking for
CUDA where there is none raises instead of falling back to the CPU.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .config import Config
from .data import SyntheticDataset, collate
from .env.environment import (alignment_stats, apply_coarse_pose,
                              bearing_init_pose, init_poses,
                              nn_alignment_stats)
from .env.episode import run_episode
from .models.agent import CMRAgent
from .models.cost_volume import IterModel, decode_topk_yaw_poses
from .models.multi_head import MultiHeadModel
from .ops.geometry import (make_se3, se3_inverse, to_disentangled,
                           transform_points)
from .train.train_iter import iter_model_state

BATCH_KEYS = ("img", "pc", "node", "pt2node", "K", "P")
# what a client of the composed pipeline sends: no ground truth, and the
# protocol amplitudes that define the hypothesis grid
COMPOSED_KEYS = ("img", "pc", "node", "pt2node", "K", "R_amplitude",
                 "T_amplitude")
_IR_STATS = ("ir_smooth", "ir_mean", "ir_norm")
# what the train steps read besides: the geo heads' labels and the agent's
# reward target
TRAIN_KEYS = BATCH_KEYS + ("pc_mask", "img_mask", "pc_idx_for_circle_loss",
                           "pc_xy_float_for_circle_loss",
                           "pc_xy_int_for_circle_loss", "pc_in_cam_space")


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from ``generator``: every Linear/Conv2d weight
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (the JAX package's torch-style
    init), biases 0; norms keep their identity init."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                u = torch.rand(m.weight.shape, generator=generator)
                m.weight.copy_((2.0 * u - 1.0) * bound)
                if m.bias is not None:
                    m.bias.zero_()


def serve_episode(model: MultiHeadModel, agent: CMRAgent, cfg: Config,
                  batch: Dict[str, torch.Tensor]) -> dict:
    """Geo forward -> ``init_poses`` (or, with ``cfg.bearing_init``, the
    bearing yaw, as the JAX package's exported episode starts) ->
    ``to_disentangled`` -> episode.

    Returns ``{"final_pose": [B,4,4], "pose_target": [B,4,4] (disentangled
    ground truth, what an evaluation compares against), "steps": per-step
    (r_logits, t_logits)}``.
    """
    with torch.inference_mode():
        out = model(batch)
        # the keys bench.py's workload hands the episode (no scores: the
        # compaction ranks by the overlap flag, i.e. keeps index order)
        state = {
            "pc": out["pc"],
            "K": batch["K"],
            "pc_overlap_pred": out["pc_overlap_pred"],
            "pc_geo_feat": out["pc_geo_feat"],
            "img_geo_feat": out["img_geo_feat"],
        }
        pose_src, pose_tgt = init_poses(batch)
        if cfg.bearing_init:
            pose_src = bearing_init_pose(state)
        final, steps, _ = run_episode(agent, state, pose_src, cfg,
                                      raster_topk=cfg.episode_raster_topk())
        return {"final_pose": final, "steps": steps,
                "pose_target": to_disentangled(pose_tgt, state["pc"])}


def synthetic_batch(cfg: Config, batch_size: int, device="cuda",
                    seed: int = 0, keys=BATCH_KEYS) -> Dict[str, torch.Tensor]:
    """``keys`` of a batch of the synthetic dataset (seeded with ``seed``)
    as tensors on ``device``."""
    dev = resolve_device(device)
    ds = SyntheticDataset(cfg, length=batch_size, seed=seed)
    batch_np = collate([ds[i] for i in range(batch_size)])
    return {k: torch.from_numpy(batch_np[k]).to(dev) for k in keys}


def build_workload(cfg: Config, batch_size: int, device="cuda", seed: int = 0
                   ) -> Tuple[Dict[str, torch.Tensor], MultiHeadModel, CMRAgent,
                              Callable[[Dict[str, torch.Tensor]], torch.Tensor]]:
    """The serving workload: ``(batch, model, agent, episode)``.

    ``batch`` holds the tensors the path reads, made by the synthetic
    dataset from ``seed``; ``model`` and ``agent`` carry random weights from
    a ``torch.Generator`` seeded with ``seed`` and are in eval mode;
    ``episode(batch)`` returns the final poses ``[B, 4, 4]``.
    """
    dev = resolve_device(device)
    batch = synthetic_batch(cfg, batch_size, dev, seed)
    gen = torch.Generator().manual_seed(seed)
    model, agent = MultiHeadModel(cfg), CMRAgent(cfg)
    init_random_(model, gen)
    init_random_(agent, gen)
    model.to(dev).eval()
    agent.to(dev).eval()

    def episode(b: Dict[str, torch.Tensor]) -> torch.Tensor:
        return serve_episode(model, agent, cfg, b)["final_pose"]

    return batch, model, agent, episode


# The synthetic-weights recipe of the coarse-to-fine workload (see
# :func:`spread_random_weights_`).
TOWER_GAIN = 3.0
OVERLAP_HEAD_GAIN = 100.0


def spread_random_weights_(geo: MultiHeadModel, iter_model: IterModel,
                           batch: Dict[str, torch.Tensor]) -> None:
    """Make freshly initialised weights take the pipeline's decisions by
    value instead of by rounding, in place. Two steps, the same that
    ``tests/test_torch_compose.py`` applies to the JAX package's variables:

    1. every convolution of the cost volume's tower times ``TOWER_GAIN``:
       at fan-in scale its ten LeakyReLU(0.01) layers score all hypotheses
       alike to seven digits, and the yaw nomination would be a tie;
    2. the last layer of the per-point overlap head times
       ``OVERLAP_HEAD_GAIN``, its bias shifted so that the median point of
       ``batch`` sits on the decision threshold: a fresh head may call
       every point overlap, and the bearing of an all-points sector is the
       atan2 of two rounding residues. After it about half the cloud is
       predicted and few points lie within rounding of the threshold.

    What no weights change: the hypothesis grid spans ``[-amplitude,
    amplitude]`` in equal steps, so at a yaw amplitude of pi its two end
    bins are one rotation and its steps compose to grid poses again; a
    second cost-volume iteration at the same amplitude (``iter_shrink`` 1)
    therefore brings several candidates to one pose, and those score alike
    to rounding. Whichever of them is selected, the pose is the same.
    """
    with torch.no_grad():
        for m in iter_model.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.mul_(TOWER_GAIN)
        logits = geo(batch)["pc_overlap_logits"].float()
        median = torch.quantile((logits[..., 1] - logits[..., 0]).flatten(),
                                0.5)
        last = geo.overlap_head.pc_overlap_head[-1]
        last.weight.mul_(OVERLAP_HEAD_GAIN)
        last.bias.mul_(OVERLAP_HEAD_GAIN)
        last.bias[1] -= (OVERLAP_HEAD_GAIN * median).to(last.bias.dtype)


def perceive(geo: MultiHeadModel, batch_k: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """Fine-stage geo forward -> episode / verification state."""
    geo_k = geo(batch_k)
    state_k = {k: geo_k[k] for k in
               ("pc", "pc_overlap_pred", "pc_is_in_cam_scores",
                "pc_geo_feat", "img_geo_feat")}
    state_k["K"] = batch_k["K"]
    return state_k


def refine_episode(cfg: Config, agent: CMRAgent,
                   state_k: Dict[str, torch.Tensor]):
    """The agent's episode on a perceived state, from the bearing yaw
    (``cfg.bearing_init``) or the identity -> ``(final disentangled pose
    [B,4,4], per-step (r_logits, t_logits))``."""
    if cfg.bearing_init:
        pose_src = bearing_init_pose(state_k)
    else:
        pose_src = torch.eye(4, device=state_k["pc"].device).expand(
            state_k["pc"].shape[0], 4, 4)
    final, steps, _ = run_episode(agent, state_k, pose_src, cfg,
                                  raster_topk=cfg.episode_raster_topk())
    return final, steps


def fine_stage(cfg: Config, geo: MultiHeadModel, agent: CMRAgent,
               batch_k: Dict[str, torch.Tensor]):
    """One fine stage of the coarse-to-fine pipeline: perceive the rebased
    problem ``batch_k`` with ``geo`` and run the agent's episode ->
    ``(episode / verification state, final disentangled pose [B,4,4])``.
    Call under ``torch.no_grad()``."""
    state_k = perceive(geo, batch_k)
    return state_k, refine_episode(cfg, agent, state_k)[0]


def _zscore(a: torch.Tensor) -> torch.Tensor:
    """Z-score along the candidate axis with the population deviation."""
    return ((a - a.mean(dim=1, keepdim=True))
            / (a.std(dim=1, keepdim=True, unbiased=False) + 1e-9))


def _combine(stats: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """Candidate-axis score matrix ``[B, K]`` for statistic ``name``;
    ``"combo"`` is z(smooth_mean) + 0.3 z(ir_smooth) across candidates."""
    if name != "combo":
        return stats[name]
    return _zscore(stats["smooth_mean"]) + 0.3 * _zscore(stats["ir_smooth"])


def _stack(dicts: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([d[k] for d in dicts], dim=1) for k in dicts[0]}


def _select(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for ``x [B, K, ...]``."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def composed_pipeline(cfg: Config, geo: MultiHeadModel, iter_model: IterModel,
                      agent: CMRAgent, *,
                      fine_geo: Optional[MultiHeadModel] = None,
                      hypotheses: int = 1, iter_iters: int = 1,
                      iter_shrink: float = 1.0,
                      hypo_score: str = "smooth_mean",
                      refine_rounds: int = 0,
                      refine_beam: Sequence[str] = (),
                      beam_score: Optional[str] = None,
                      beam_frame: str = "own"
                      ) -> Callable[[Dict[str, torch.Tensor]],
                                    Dict[str, torch.Tensor]]:
    """The coarse-to-fine registration pipeline as one callable: raw batch
    -> cost-volume coarse search over the top-``hypotheses`` yaw candidates
    (each followed by ``iter_iters - 1`` further cost-volume iterations,
    the grid shrunk by ``iter_shrink`` each time) -> per-candidate
    re-perception and agent episode -> feature-alignment verification ->
    the selected absolute pose -> optionally ``refine_rounds`` verified
    rounds (accepted per sample where the statistic improves) over a beam
    of statistic-nominated candidates (``refine_beam`` entries ``"stat"``
    or ``"stat:R"`` for the rank-R nominee), re-voted by ``beam_score``
    in each member's own frame or, with ``beam_frame="shared"``, by every
    member's pose scored in every member's frame.

    The counterpart of the function inside the JAX package's
    ``export_composed_pipeline`` (train/export.py:177-350). ``hypo_score``,
    ``beam_score`` and the beam's statistics are keys of
    ``alignment_stats`` / ``nn_alignment_stats`` or ``"combo"``.
    ``fine_geo`` perceives the fine stages (default: ``geo``). All modules
    should be in ``eval()`` mode.

    The callable takes ``COMPOSED_KEYS`` (no ground truth) and returns
    ``pose [B,4,4]`` (absolute SE(3) taking the input cloud into camera
    alignment), ``score [B]`` (the winner's statistic) and
    ``candidate_scores [B, hypotheses]``.
    """
    fine = fine_geo if fine_geo is not None else geo
    beam_score = beam_score or hypo_score
    beam_specs = tuple((s.partition(":")[0], int(s.partition(":")[2] or 1))
                       for s in refine_beam)
    if beam_frame not in ("own", "shared"):
        raise ValueError(f"beam_frame must be 'own' or 'shared', got "
                         f"{beam_frame!r}")
    need_ir = any(s == "combo" or s in _IR_STATS
                  for s in (hypo_score, beam_score,
                            *(n for n, _ in beam_specs)))
    h, w = cfg.image_h, cfg.image_w

    def cand_stats(state_k, final):
        stats = alignment_stats(state_k, final, h, w)
        if need_ir:   # the whole-image nearest-pixel search is the dear half
            stats.update(nn_alignment_stats(state_k, final, h, w))
        return stats

    def run_fine(batch_k):
        return fine_stage(cfg, fine, agent, batch_k)

    def entangle_and_compose(state_k, final, coarse):
        """Absolute pose = entangled episode estimate after the coarse
        rebase (``t_abs = t + mu - R mu``)."""
        mu = state_k["pc"].float().mean(dim=1)
        Rf, tf = final[..., :3, :3].float(), final[..., :3, 3].float()
        t_abs = tf + mu - torch.einsum("bij,bj->bi", Rf, mu)
        return make_se3(Rf, t_abs) @ coarse

    def tail_iters(stk):
        for _ in range(1, iter_iters):
            if iter_shrink != 1.0:
                stk = dict(stk, R_amplitude=stk["R_amplitude"] * iter_shrink,
                           T_amplitude=stk["T_amplitude"] * iter_shrink)
            o = iter_model(stk, with_loss=False)
            stk = dict(stk, pc_i=o["pc_i"],
                       matrix_accumulated=o["matrix_accumulated"])
        return stk

    def refine(batch, total, name):
        """``refine_rounds`` verified rounds from estimate ``total``,
        accepted per sample only where statistic ``name`` improves in the
        round's perception frame -> ``(pose, accepted stats)``."""
        eye = torch.eye(4, device=total.device).expand_as(total)
        last = None
        for _ in range(refine_rounds):
            state_m, final_m = run_fine(apply_coarse_pose(batch, total))
            cand_total = entangle_and_compose(state_m, final_m, total)
            s_new = cand_stats(state_m, final_m)
            s_inc = cand_stats(state_m, eye)   # the incumbent is identity here
            acc = _combine(_stack([s_new, s_inc]), name).argmax(dim=1) == 0
            total = torch.where(acc[:, None, None], cand_total, total)
            last = {k: torch.where(acc, s_new[k], s_inc[k]) for k in s_new}
        return total, last

    def shared_frame_scores(batch, m_poses):
        """Every member's absolute pose scored in every member's perception
        frame, z-scored across poses within a frame, averaged over frames."""
        frame_scores = []
        for t_frame in m_poses:
            state_f = perceive(fine, apply_coarse_pose(batch, t_frame))
            inv_f = se3_inverse(t_frame)
            per_pose = [cand_stats(state_f, to_disentangled(t_pose @ inv_f,
                                                            state_f["pc"]))
                        for t_pose in m_poses]
            frame_scores.append(_zscore(_combine(_stack(per_pose),
                                                 beam_score)))
        return sum(frame_scores) / len(frame_scores)

    @torch.no_grad()
    def pipeline(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch = {k: batch[k] for k in COMPOSED_KEYS}
        st = iter_model_state(geo(batch), batch)
        out = iter_model(st, with_loss=False)
        cands = decode_topk_yaw_poses(
            out["cost_volume_logits"], st["R_amplitude"], st["T_amplitude"],
            cfg.nlabel, hypotheses)
        poses, stat_list = [], []
        for k in range(hypotheses):
            mk = cands[:, k]
            stk = tail_iters(dict(
                st, pc_i=transform_points(st["pc_i"], mk[:, :3, :3],
                                          mk[:, :3, 3]),
                matrix_accumulated=mk @ st["matrix_accumulated"]))
            coarse = stk["matrix_accumulated"]
            state_k, final = run_fine(apply_coarse_pose(batch, coarse))
            poses.append(entangle_and_compose(state_k, final, coarse))
            stat_list.append(cand_stats(state_k, final))
        stats_mat = _stack(stat_list)                           # [B, K] each
        scores = _combine(stats_mat, hypo_score)
        poses = torch.stack(poses, dim=1)                       # [B, K, 4, 4]
        sel = scores.argmax(dim=1)
        pose, score = _select(poses, sel), _select(scores, sel)
        if refine_rounds > 0:
            m_poses, m_stats = [], []
            for name, rank in beam_specs or ((hypo_score, 1),):
                sc = _combine(stats_mat, name)
                # a stable sort: ties go to the lower candidate, as argsort
                # of the negated scores does in the JAX package
                idx = torch.sort(sc, dim=1, descending=True, stable=True
                                 ).indices[:, rank - 1]
                total_m, last = refine(batch, _select(poses, idx), name)
                m_poses.append(total_m)
                m_stats.append(last)
            if len(m_poses) > 1:
                bscore = (shared_frame_scores(batch, m_poses)
                          if beam_frame == "shared"
                          else _combine(_stack(m_stats), beam_score))
                bsel = bscore.argmax(dim=1)
                pose = _select(torch.stack(m_poses, dim=1), bsel)
                score = _select(bscore, bsel)
            else:
                pose = m_poses[0]
                # combo is a cross-candidate z-score, meaningless for one
                # member: report the accepted smooth_mean then
                score = m_stats[0]["smooth_mean" if hypo_score == "combo"
                                   else hypo_score]
        return {"pose": pose, "score": score, "candidate_scores": scores}

    return pipeline


def build_composed_workload(cfg: Config, batch_size: int, device="cuda",
                            seed: int = 0, **pipeline_options):
    """The coarse-to-fine serving workload: ``(batch, (geo, iter_model,
    agent), pipeline)``.

    ``batch`` holds ``COMPOSED_KEYS`` of the synthetic dataset made from
    ``seed``; the three modules carry random weights from a
    ``torch.Generator`` seeded with ``seed`` and are in eval mode;
    ``pipeline`` is :func:`composed_pipeline` with ``pipeline_options``.
    The fresh weights then go through :func:`spread_random_weights_`.
    """
    dev = resolve_device(device)
    batch = synthetic_batch(cfg, batch_size, dev, seed, keys=COMPOSED_KEYS)
    gen = torch.Generator().manual_seed(seed)
    modules = (MultiHeadModel(cfg), IterModel(cfg), CMRAgent(cfg))
    for m in modules:
        init_random_(m, gen)
        m.to(dev).eval()
    spread_random_weights_(modules[0], modules[1], batch)
    return batch, modules, composed_pipeline(cfg, *modules,
                                             **pipeline_options)
