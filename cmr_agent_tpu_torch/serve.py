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

import collections
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from .config import Config
from .data import SyntheticDataset, collate
from .data.synthetic import sample_settings
from .env.environment import (alignment_stats, apply_coarse_pose,
                              bearing_init_pose, compose_disentangled,
                              init_poses, nn_alignment_stats)
from .env.episode import run_episode
from .models.agent import CMRAgent
from .models.cost_volume import IterModel, decode_topk_yaw_poses
from .models.multi_head import MultiHeadModel
from .ops.geometry import se3_inverse, to_disentangled, transform_points
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


_HOST_BATCHES: "collections.OrderedDict[tuple, dict]" = \
    collections.OrderedDict()


def _host_batch(cfg: Config, batch_size: int, seed: int) -> dict:
    """The collated host batch of :func:`synthetic_batch`, kept (the 16
    used last) for the next call with the same dataset settings
    (:func:`.data.synthetic.sample_settings`), size and seed: a scene costs
    the dataset's numpy sampling over its whole cloud."""
    key = (sample_settings(cfg), batch_size, seed)
    batch = _HOST_BATCHES.pop(key, None)
    if batch is None:
        ds = SyntheticDataset(cfg, length=batch_size, seed=seed)
        batch = collate([ds[i] for i in range(batch_size)])
    _HOST_BATCHES[key] = batch
    while len(_HOST_BATCHES) > 16:
        _HOST_BATCHES.popitem(last=False)
    return batch


def synthetic_batch(cfg: Config, batch_size: int, device="cuda",
                    seed: int = 0, keys=BATCH_KEYS) -> Dict[str, torch.Tensor]:
    """``keys`` of a batch of the synthetic dataset (seeded with ``seed``)
    as tensors on ``device``, each a copy of its own."""
    dev = resolve_device(device)
    batch_np = _host_batch(cfg, batch_size, seed)
    return {k: torch.from_numpy(batch_np[k]).to(dev, copy=True) for k in keys}


def build_workload(cfg: Config, batch_size: int, device="cuda", seed: int = 0
                   ) -> Tuple[Dict[str, torch.Tensor], MultiHeadModel, CMRAgent,
                              Callable[[Dict[str, torch.Tensor]], torch.Tensor]]:
    """The serving workload: ``(batch, model, agent, episode)``.

    ``batch`` holds the tensors the path reads, made by the synthetic
    dataset from ``seed``; ``model`` and ``agent`` carry random weights from
    a ``torch.Generator`` seeded with ``seed`` (the same for every
    ``cfg.fused_stacks``: fusion changes the compute, not the parameters)
    and are in eval mode; ``episode(batch)`` returns the final poses
    ``[B, 4, 4]``, through the raster of ``cfg.raster_mode``.
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
    centre_overlap_head_(geo, batch)


def centre_overlap_head_(geo: MultiHeadModel,
                         batch: Dict[str, torch.Tensor]) -> None:
    """Step 2 of :func:`spread_random_weights_` alone, in place: the last
    layer of the per-point overlap head times ``OVERLAP_HEAD_GAIN``, its
    bias shifted so that the median point of ``batch`` sits on the
    decision threshold (about half the cloud is then predicted overlap,
    where a fresh head may predict all of it or none)."""
    with torch.no_grad():
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


def candidate_stats(state_k: Dict[str, torch.Tensor], final: torch.Tensor,
                    cfg: Config, need_ir: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """The verification statistics ``[B]`` of the disentangled pose
    ``final`` on a perceived state: ``alignment_stats`` and, with
    ``need_ir`` (the whole-image nearest-pixel search is the dear half),
    ``nn_alignment_stats``."""
    stats = alignment_stats(state_k, final, cfg.image_h, cfg.image_w)
    if need_ir:
        stats.update(nn_alignment_stats(state_k, final, cfg.image_h,
                                        cfg.image_w))
    return stats


def tail_iters(iter_model: IterModel, st: Dict[str, torch.Tensor],
               iter_iters: int, iter_shrink: float = 1.0
               ) -> Dict[str, torch.Tensor]:
    """Cost-volume iterations ``1 .. iter_iters - 1`` from state ``st``,
    each on the grid of the one before times ``iter_shrink``."""
    for _ in range(1, iter_iters):
        if iter_shrink != 1.0:
            st = dict(st, R_amplitude=st["R_amplitude"] * iter_shrink,
                      T_amplitude=st["T_amplitude"] * iter_shrink)
        o = iter_model(st, with_loss=False)
        st = dict(st, pc_i=o["pc_i"],
                  matrix_accumulated=o["matrix_accumulated"])
    return st


def coarse_candidates(cfg: Config, iter_model: IterModel,
                      st: Dict[str, torch.Tensor], hypotheses: int,
                      iter_iters: int = 1, iter_shrink: float = 1.0):
    """The coarse search: the first cost-volume decode's top-``hypotheses``
    yaw candidates, each carried through the remaining ``iter_iters - 1``
    iterations -> a list of ``hypotheses`` entangled coarse poses ``[B, 4,
    4]`` (the accumulated matrix of each branch)."""
    out = iter_model(st, with_loss=False)
    cands = decode_topk_yaw_poses(out["cost_volume_logits"], st["R_amplitude"],
                                  st["T_amplitude"], cfg.nlabel, hypotheses)
    coarse = []
    for k in range(hypotheses):
        mk = cands[:, k]
        stk = tail_iters(iter_model, dict(
            st, pc_i=transform_points(st["pc_i"], mk[:, :3, :3],
                                      mk[:, :3, 3]),
            matrix_accumulated=mk @ st["matrix_accumulated"]),
            iter_iters, iter_shrink)
        coarse.append(stk["matrix_accumulated"])
    return coarse


def rank_pick(scores: torch.Tensor, rank: int) -> torch.Tensor:
    """Each sample's rank-``rank`` candidate of ``scores [B, K]`` (1 = the
    best). A stable sort: ties go to the lower candidate, as argsort of the
    negated scores does in the JAX package."""
    return torch.sort(scores, dim=1, descending=True,
                      stable=True).indices[:, rank - 1]


def _select(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for ``x [B, K, ...]``."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _with_combo(stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Candidate-axis statistics ``[B, K]`` with ``"combo"`` added where
    the nearest-pixel half was computed."""
    if "ir_smooth" not in stats:
        return stats
    return dict(stats, combo=_combine(stats, "combo"))


class CoarseToFine:
    """The body of the coarse-to-fine registration pipeline, which
    :func:`composed_pipeline` serves and the evaluation CLI
    (``cli.test_agent``) scores against the ground truth.

    Calling it on a batch runs the cost volume's coarse search over the
    top-``hypotheses`` yaw candidates (each followed by ``iter_iters - 1``
    further iterations, the grid shrunk by ``iter_shrink`` each time), each
    candidate's re-perception by ``fine_geo`` (default ``geo``) and agent
    episode, the feature-alignment verification and the selection by
    ``hypo_score``; then, with ``refine_rounds``, that many verified rounds
    from each member of a beam of statistic-nominated candidates
    (``refine_beam`` entries ``"stat"`` or ``"stat:R"`` for the rank-R
    nominee; without it the selected candidate alone), re-voted by
    ``beam_score`` in each member's own frame or, with
    ``beam_frame="shared"``, by every member's pose scored in every
    member's frame.

    The JAX package's two programs of this pipeline differ, and two options
    pick one: its exported pipeline (train/export.py:177-350) accepts a
    member's refined pose by the member's own statistic and ranks the
    episode's observation compaction by ``pc_is_in_cam_scores``; its
    evaluation CLI accepts by ``hypo_score`` for every member
    (``accept_score``) and runs the episode on a state without those
    scores (``rank_by_scores=False``: the compaction keeps index order).
    Only the CLI has ``refine_iter``: each round first re-decodes the
    residual with the cost volume on a grid shrunk by ``refine_shrink``.

    Statistics are keys of ``alignment_stats`` / ``nn_alignment_stats`` or
    ``"combo"``; ``need_ir`` (default: whether a statistic in use needs
    it) computes the nearest-pixel half. ``iter_model`` may be ``None``
    for :meth:`refine` alone. Modules in ``eval()`` mode; call under
    ``torch.no_grad()``.
    """

    def __init__(self, cfg: Config, geo: MultiHeadModel,
                 iter_model: Optional[IterModel], agent: CMRAgent, *,
                 fine_geo: Optional[MultiHeadModel] = None,
                 hypotheses: int = 1, iter_iters: int = 1,
                 iter_shrink: float = 1.0, hypo_score: str = "smooth_mean",
                 refine_rounds: int = 0, refine_beam: Sequence[str] = (),
                 beam_score: Optional[str] = None, beam_frame: str = "own",
                 accept_score: Optional[str] = None,
                 rank_by_scores: bool = True, refine_iter: bool = False,
                 refine_shrink: float = 0.25,
                 need_ir: Optional[bool] = None):
        if beam_frame not in ("own", "shared"):
            raise ValueError(f"beam_frame must be 'own' or 'shared', got "
                             f"{beam_frame!r}")
        self.cfg, self.geo, self.iter_model, self.agent = (cfg, geo,
                                                           iter_model, agent)
        self.fine = fine_geo if fine_geo is not None else geo
        self.hypotheses, self.iter_iters = hypotheses, iter_iters
        self.iter_shrink, self.hypo_score = iter_shrink, hypo_score
        self.refine_rounds, self.beam_frame = refine_rounds, beam_frame
        self.beam_score = beam_score or hypo_score
        self.beam_specs = tuple((s.partition(":")[0],
                                 int(s.partition(":")[2] or 1))
                                for s in refine_beam)
        self.accept_score, self.rank_by_scores = accept_score, rank_by_scores
        self.refine_iter, self.refine_shrink = refine_iter, refine_shrink
        if need_ir is None:
            need_ir = any(s == "combo" or s in _IR_STATS
                          for s in (hypo_score, self.beam_score,
                                    *(n for n, _ in self.beam_specs)))
        self.need_ir = need_ir

    def stats(self, state_k, final):
        return candidate_stats(state_k, final, self.cfg, self.need_ir)

    def episode(self, state_k):
        """The agent's episode on a perceived state -> ``(final
        disentangled pose [B,4,4], per-step (r_logits, t_logits))``."""
        if not self.rank_by_scores:
            state_k = {k: v for k, v in state_k.items()
                       if k != "pc_is_in_cam_scores"}
        return refine_episode(self.cfg, self.agent, state_k)

    def run_fine(self, batch_k):
        """Re-perceive the rebased problem ``batch_k`` with the fine geo
        model and run the episode -> ``(state, final, steps)``."""
        state_k = perceive(self.fine, batch_k)
        return (state_k, *self.episode(state_k))

    def search(self, batch) -> dict:
        """The coarse search and the fine stage of every candidate ->
        ``coarse`` (entangled) and ``final`` (disentangled episode
        estimates) ``[B, K, 4, 4]``, each candidate's episode ``steps``,
        ``stats`` ``[B, K]`` per statistic, the selection ``sel [B]`` and
        the absolute ``poses [B, K, 4, 4]``."""
        st = iter_model_state(self.geo(batch), batch)
        coarse, finals, steps, stats = [], [], [], []
        for c in coarse_candidates(self.cfg, self.iter_model, st,
                                   self.hypotheses, self.iter_iters,
                                   self.iter_shrink):
            state_k, final, steps_k = self.run_fine(
                apply_coarse_pose(batch, c))
            coarse.append(c)
            finals.append(final)
            steps.append(steps_k)
            stats.append(self.stats(state_k, final))
        stats_mat = _with_combo(_stack(stats))
        poses = [compose_disentangled(f, c, batch["pc"])
                 for f, c in zip(finals, coarse)]
        return {"coarse": torch.stack(coarse, dim=1),
                "final": torch.stack(finals, dim=1), "steps": steps,
                "stats": stats_mat,
                "sel": stats_mat[self.hypo_score].argmax(dim=1),
                "poses": torch.stack(poses, dim=1)}

    def refine(self, batch, total: torch.Tensor, name: str):
        """``refine_rounds`` verified rounds from the absolute estimate
        ``total [B, 4, 4]``: each rebases ``batch`` under it (after the
        ``refine_iter`` re-decode), runs the fine stage and keeps the new
        estimate per sample only where statistic ``accept_score`` (default
        ``name``) beats the incumbent's in the round's own frame. Returns
        ``(pose, the kept pose's statistics [B] per key, the rounds: each
        one's rebase ``base``, episode ``final`` and ``accept [B]``)``."""
        accept_by = self.accept_score or name
        eye = torch.eye(4, device=total.device).expand_as(total)
        last, rounds = None, []
        for _ in range(self.refine_rounds):
            coarse_r, base = eye, total
            if self.refine_iter:
                batch_c = apply_coarse_pose(batch, total)
                st = iter_model_state(self.geo(batch_c), batch_c)
                st = dict(st, R_amplitude=st["R_amplitude"]
                          * self.refine_shrink,
                          T_amplitude=st["T_amplitude"] * self.refine_shrink)
                coarse_r = self.iter_model(st, with_loss=False)[
                    "matrix_accumulated"]
                base = coarse_r @ total
            batch_r = apply_coarse_pose(batch, base)
            state_r, final_r, _ = self.run_fine(batch_r)
            # the incumbent, seen from the round's frame
            incumbent = to_disentangled(se3_inverse(coarse_r), batch_r["pc"])
            s_new = self.stats(state_r, final_r)
            s_inc = self.stats(state_r, incumbent)
            acc = _with_combo(_stack([s_new, s_inc]))[accept_by].argmax(
                dim=1) == 0
            total = torch.where(acc[:, None, None], compose_disentangled(
                final_r, base, batch["pc"]), total)
            last = {k: torch.where(acc, s_new[k], s_inc[k]) for k in s_new}
            rounds.append({"base": base, "final": final_r, "accept": acc})
        return total, last, rounds

    def shared_frame_stats(self, batch, poses) -> Dict[str, torch.Tensor]:
        """Every pose of ``poses`` scored in every pose's perception frame,
        z-scored across poses within a frame, averaged over frames ->
        ``[B, M]`` per statistic."""
        frames = []
        for t_frame in poses:
            state_f = perceive(self.fine, apply_coarse_pose(batch, t_frame))
            inv_f = se3_inverse(t_frame)
            frames.append(_with_combo(_stack([
                self.stats(state_f, to_disentangled(t_pose @ inv_f,
                                                    state_f["pc"]))
                for t_pose in poses])))
        return {k: torch.stack([_zscore(f[k]) for f in frames]).mean(dim=0)
                for k in frames[0]}

    def beam(self, batch, rec: dict) -> dict:
        """Refine each beam member of the search record ``rec`` ->
        ``members`` (each with its candidate ``idx [B]``, refined ``pose``,
        ``stats`` and ``rounds``) and, for more than one member, the
        re-vote's ``beam_stats [B, M]`` per statistic and ``bsel [B]``."""
        members = []
        for name, rank in self.beam_specs or ((self.hypo_score, 1),):
            idx = rank_pick(rec["stats"][name], rank)
            pose, stats, rounds = self.refine(batch, _select(rec["poses"],
                                                             idx), name)
            members.append({"idx": idx, "pose": pose, "stats": stats,
                            "rounds": rounds})
        out = {"members": members}
        if len(members) > 1:
            bmat = (self.shared_frame_stats(batch, [m["pose"]
                                                    for m in members])
                    if self.beam_frame == "shared"
                    else _with_combo(_stack([m["stats"] for m in members])))
            out.update(beam_stats=bmat,
                       bsel=bmat[self.beam_score].argmax(dim=1))
        return out

    def __call__(self, batch) -> dict:
        """:meth:`search`'s record, with :meth:`beam`'s under
        ``refine_rounds``."""
        rec = self.search(batch)
        if self.refine_rounds > 0:
            rec.update(self.beam(batch, rec))
        return rec


def composed_pipeline(cfg: Config, geo: MultiHeadModel, iter_model: IterModel,
                      agent: CMRAgent, **options
                      ) -> Callable[[Dict[str, torch.Tensor]],
                                    Dict[str, torch.Tensor]]:
    """The coarse-to-fine registration pipeline as one callable, the
    counterpart of the function inside the JAX package's
    ``export_composed_pipeline`` (train/export.py:177-350): the record of
    :class:`CoarseToFine` with ``options`` (its keyword arguments but
    ``accept_score``, ``rank_by_scores`` and ``refine_iter``, which the
    export lacks) reduced to what a client receives.

    The callable takes ``COMPOSED_KEYS`` (no ground truth) and returns
    ``pose [B,4,4]`` (absolute SE(3) taking the input cloud into camera
    alignment), ``score [B]`` (the winner's statistic) and
    ``candidate_scores [B, hypotheses]``.
    """
    body = CoarseToFine(cfg, geo, iter_model, agent, **options)

    @torch.no_grad()
    def pipeline(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        rec = body({k: batch[k] for k in COMPOSED_KEYS})
        scores = rec["stats"][body.hypo_score]
        if "bsel" in rec:
            pose = _select(torch.stack([m["pose"] for m in rec["members"]],
                                       dim=1), rec["bsel"])
            score = _select(rec["beam_stats"][body.beam_score], rec["bsel"])
        elif "members" in rec:
            pose = rec["members"][0]["pose"]
            # combo is a cross-candidate z-score, meaningless for one
            # member: report the accepted smooth_mean then
            score = rec["members"][0]["stats"][
                "smooth_mean" if body.hypo_score == "combo"
                else body.hypo_score]
        else:
            pose = _select(rec["poses"], rec["sel"])
            score = _select(scores, rec["sel"])
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
