"""Per-step policy diagnostics for a trained agent snapshot (the JAX
package's ``tools/diagnose_agent.py``).

Replays deterministic episodes on a held-out synthetic pool and prints, for
every episode step k: the mean RTE / RRE across the pool; the
policy-vs-expert action histograms of the rotation head and the two
translation heads; the rotation direction agreement (raw, balanced per
direction, small steps where the expert wants big ones, no step where it
wants a big one); the 2-D raster occupancy (predicted-overlap points inside
the frustum); and the oracle yaw direction (the sign of the overlap
sector's bearing against the expert's). Mirrors the reference's manual
debug prints (Train_Agent.py:223-250)::

    python -m cmr_agent_tpu_torch.tools.diagnose_agent --full \\
        --scene structured --geo-ckpt runs_r4/geo_45 \\
        --agent-ckpt runs_r4/agent_45 --pose-aware --aux-head --bearing-init

Checkpoints load as the CLIs load them (a weight export, the Orbax tree it
came from, or a reference ``.pth``); ``--full`` is the KITTI width in
bf16, otherwise the tiny configuration. ``--device cpu`` runs the kernels'
plain versions.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import serve


def build_pool(cfg, args, device):
    """The pool's batches on ``device``: ``--pool-size`` synthetic samples
    from ``--seed`` in batches of ``--batch-size`` (the host ops for
    ``--full``)."""
    from ..cli.common import to_device
    from ..data import DataLoader, SyntheticDataset

    fps_fn = nn_fn = None
    if args.full:
        from ..native import get_fast_host_ops
        fps_fn, nn_fn = get_fast_host_ops()
    if args.pool_size % args.batch_size:
        raise SystemExit(
            f"--pool-size {args.pool_size} must be a multiple of "
            f"--batch-size {args.batch_size}: the loader drops ragged "
            f"tails, which would silently shrink (or empty) the pool")
    ds = SyntheticDataset(cfg, length=args.pool_size, seed=args.seed,
                          fps_fn=fps_fn, nn_fn=nn_fn, scene=args.scene)
    loader = DataLoader(ds, args.batch_size, shuffle=False, num_workers=0,
                        seed=args.seed)
    return [to_device(b, device) for b in loader]


def replay_poses(cfg, traj, batch, init_pose=None):
    """The pose errors after each step k, by replaying the recorded
    ``action_r/t [K, B, ...]`` (the action application is deterministic):
    ``(RTE [K+1, B], RRE [K+1, B], final pose)``, numpy errors."""
    from ..env.environment import apply_action, init_poses
    from ..env.episode import step_tables
    from ..ops.geometry import pose_diff, to_disentangled

    pose, tgt = init_poses(batch)
    if init_pose is not None:
        pose = init_pose
    r_steps, t_steps = step_tables(cfg, pose.device)
    tgt = to_disentangled(tgt, batch["pc"])
    errs = [pose_diff(pose, tgt)]
    for k in range(traj["action_r"].shape[0]):
        pose = apply_action(torch.as_tensor(traj["action_r"][k],
                                            device=pose.device),
                            torch.as_tensor(traj["action_t"][k],
                                            device=pose.device),
                            pose, r_steps, t_steps, cfg.is_6_dof)
        errs.append(pose_diff(pose, tgt))
    rte = np.stack([e[0].cpu().numpy() for e in errs])
    rre = np.stack([e[1].cpu().numpy() for e in errs])
    return rte, rre, pose


def raster_occupancy(cfg, batch, geo_out, poses_rte_unused, traj,
                     init_pose=None):
    """Per step, replaying the recorded actions: the predicted-overlap
    points inside the frustum ``[K+1, B]``, and the oracle yaw direction's
    hits and counts ``[K, B]`` (does the sign of the overlap points' mean
    bearing agree with the expert's yaw direction?)."""
    from ..env.environment import apply_action, init_poses
    from ..env.episode import step_tables
    from ..ops.geometry import (frustum_mask, project_points,
                                transform_points_disentangled)

    pose, _ = init_poses(batch)
    if init_pose is not None:
        pose = init_pose
    r_steps, t_steps = step_tables(cfg, pose.device)
    pc = geo_out["pc"]
    overlap = geo_out["pc_overlap_pred"].bool()
    zero_idx = len(cfg.r_steps_deg) // 2
    counts, oracle_hits, oracle_n = [], [], []
    for k in range(traj["action_r"].shape[0] + 1):
        moved = transform_points_disentangled(pc, pose[:, :3, :3],
                                              pose[:, :3, 3])
        proj = project_points(moved, batch["K"])
        in_cam = frustum_mask(proj, w=cfg.image_w, h=cfg.image_h)
        counts.append((in_cam & overlap).sum(dim=1).cpu().numpy())
        if k < traj["action_r"].shape[0]:
            m = moved.cpu().numpy()
            w = overlap.cpu().numpy().astype(np.float64)
            cx = (m[..., 0] * w).sum(1) / np.maximum(w.sum(1), 1)
            cz = (m[..., 2] * w).sum(1) / np.maximum(w.sum(1), 1)
            bearing = np.arctan2(cx, cz)               # 0 = straight ahead
            exp_dir = np.sign(np.asarray(traj["expert_action_r"][k])[:, 0]
                              - zero_idx)
            want = exp_dir != 0
            oracle_hits.append((np.sign(bearing) == -exp_dir) & want)
            oracle_n.append(want)
            pose = apply_action(torch.as_tensor(traj["action_r"][k],
                                                device=pose.device),
                                torch.as_tensor(traj["action_t"][k],
                                                device=pose.device),
                                pose, r_steps, t_steps, cfg.is_6_dof)
    return np.stack(counts), np.stack(oracle_hits), np.stack(oracle_n)


def _episode_fn(cfg, agent):
    """The deterministic episode with expert labels, its trajectory's
    actions as numpy ``[K, B, ...]``."""
    from ..env.environment import bearing_init_pose, init_poses
    from ..env.episode import run_episode
    from ..ops.geometry import to_disentangled
    from ..train.train_agent import episode_state

    def episode(batch, geo_out):
        state = episode_state(geo_out, batch)
        pose_src, pose_tgt = init_poses(state)
        if cfg.bearing_init:
            pose_src = bearing_init_pose(state)
        pose_tgt = to_disentangled(pose_tgt, state["pc"])
        with torch.no_grad():
            _, _, traj = run_episode(
                agent, state, pose_src, cfg, cfg.episode_raster_topk(),
                pose_target=pose_tgt, deterministic=True, with_expert=True,
                collect_trajectory=True)
        keep = ("action_r", "action_t", "expert_action_r",
                "expert_action_t")
        return {k: traj[k].cpu().numpy() for k in keep}

    return episode


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--full", action="store_true")
    p.add_argument("--scene", default="structured",
                   choices=["random", "structured"])
    p.add_argument("--pool-size", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seed", type=int, default=7919,
                   help="pool seed (default: the convergence demo's "
                        "held-out validation pool)")
    p.add_argument("--geo-ckpt", required=True)
    p.add_argument("--agent-ckpt", default="",
                   help="omit to diagnose an untrained agent")
    p.add_argument("--pose-aware", action="store_true",
                   help="must match how the snapshot was trained")
    p.add_argument("--obs-bearing", action="store_true",
                   help="must match how the snapshot was trained "
                        "(Config.obs_bearing_channels)")
    p.add_argument("--aux-head", action="store_true",
                   help="must match how the snapshot was trained "
                        "(Config.policy_aux_state; implies --obs-bearing)")
    p.add_argument("--bearing-init", action="store_true",
                   help="start episodes from the coarse bearing-aligned "
                        "yaw (Config.bearing_init)")
    p.add_argument("--oracle-overlap", action="store_true",
                   help="ABLATION: ground-truth overlap flags instead of "
                        "the geo head's predictions")
    p.add_argument("--t-amp", type=float, default=None)
    p.add_argument("--r-amp", type=float, default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' (the kernels' plain "
                        "versions)")
    args = p.parse_args(argv)

    from ..cli.common import apply_obs_overrides, load_model
    from ..env.environment import bearing_init_pose
    from ..models.agent import CMRAgent
    from ..models.multi_head import MultiHeadModel
    from ..train.train_geo import make_geo_forward, wrap_oracle_overlap

    dev = serve.resolve_device(args.device)
    if args.full:
        from ..config import kitti_config
        cfg = kitti_config(compute_dtype="bfloat16",
                           train_batch_size=args.batch_size)
    else:
        from ..config import tiny_config
        cfg = tiny_config(train_batch_size=args.batch_size)
    cfg = apply_obs_overrides(cfg, args)

    pool = build_pool(cfg, args, dev)
    geo = load_model(cfg, MultiHeadModel(cfg), args.geo_ckpt, "multihead",
                     "geo", dev)
    agent = load_model(cfg, CMRAgent(cfg), args.agent_ckpt, "agent",
                       "agent", dev)
    raw_fwd = make_geo_forward(cfg)
    fwd = wrap_oracle_overlap(raw_fwd) if args.oracle_overlap else raw_fwd
    episode = _episode_fn(cfg, agent)

    K = cfg.action_num
    n_act = len(cfg.r_steps_deg)
    zero_idx = n_act // 2                              # the 0.0 step
    rte_all, rre_all, occ_all, orh_all, orn_all = [], [], [], [], []
    hist_pol = np.zeros((K, n_act), np.int64)
    hist_exp = np.zeros((K, n_act), np.int64)
    t_hist_pol = np.zeros((K, n_act), np.int64)
    t_hist_exp = np.zeros((K, n_act), np.int64)
    sign_agree = np.zeros(K)
    zero_while_far = np.zeros(K)
    small_while_big = np.zeros(K)      # |pol step| small when expert's big
    big_n = np.zeros(K)
    dir_hits = np.zeros((K, 2))        # balanced: recall per direction
    dir_n = np.zeros((K, 2))
    n_seen = 0
    for batch in pool:
        geo_out = fwd(geo, batch)
        traj = episode(batch, geo_out)
        init = None
        if cfg.bearing_init:
            init = bearing_init_pose({"pc": geo_out["pc"],
                                      "pc_overlap_pred":
                                          geo_out["pc_overlap_pred"]})
        rte, rre, _ = replay_poses(cfg, traj, batch, init_pose=init)
        rte_all.append(rte)
        rre_all.append(rre)
        occ, orh, orn = raster_occupancy(cfg, batch, geo_out, None, traj,
                                         init_pose=init)
        occ_all.append(occ)
        orh_all.append(orh)
        orn_all.append(orn)
        ar = traj["action_r"][:, :, 0]                 # [K, B] yaw head
        er = traj["expert_action_r"][:, :, 0]
        for k in range(K):
            hist_pol[k] += np.bincount(ar[k], minlength=n_act)
            hist_exp[k] += np.bincount(er[k], minlength=n_act)
            t_hist_pol[k] += np.bincount(traj["action_t"][k].ravel(),
                                         minlength=n_act)
            t_hist_exp[k] += np.bincount(traj["expert_action_t"][k].ravel(),
                                         minlength=n_act)
            pol_dir = np.sign(ar[k] - zero_idx)
            exp_dir = np.sign(er[k] - zero_idx)
            sign_agree[k] += (pol_dir == exp_dir).sum()
            far = np.abs(er[k] - zero_idx) >= 4        # expert wants big
            zero_while_far[k] += ((ar[k] == zero_idx) & far).sum()
            # a constant small-step policy evades zero-while-far and
            # inflates raw sign-agree on a direction-imbalanced pool:
            # track the magnitude miss and the per-direction recall
            small_while_big[k] += ((np.abs(ar[k] - zero_idx) <= 2)
                                   & far).sum()
            big_n[k] += far.sum()
            for d, col in ((-1, 0), (1, 1)):
                want = exp_dir == d
                dir_hits[k, col] += (pol_dir[want] == d).sum()
                dir_n[k, col] += want.sum()
        n_seen += ar.shape[1]

    rte = np.concatenate(rte_all, axis=1)              # [K+1, total]
    rre = np.concatenate(rre_all, axis=1)
    occ = np.concatenate(occ_all, axis=1)
    orh = np.concatenate(orh_all, axis=1)
    orn = np.concatenate(orn_all, axis=1)
    # the bearing's sign convention is empirical: report the better one
    acc = orh.sum() / max(orn.sum(), 1)
    oracle_flip = acc < 0.5
    oracle = np.where(orn.sum(1) > 0,
                      (orn ^ orh if oracle_flip else orh).sum(1)
                      / np.maximum(orn.sum(1), 1), np.nan)
    steps_deg = [f"{s:+.4g}" for s in np.degrees(cfg.r_steps_array())]
    steps_m = [f"{s:+.4g}" for s in cfg.t_steps_array()]

    print(f"pool {rte.shape[1]} samples  K={K}  "
          f"(policy argmax, expert alongside)")
    print(f"oracle yaw-direction accuracy (sign of overlap-sector bearing"
          f"{', flipped convention' if oracle_flip else ''}): "
          f"{max(acc, 1 - acc):.2f} overall")
    print("\nstep |  RTE(m)  RRE(deg) | raster-occ | r sign-agree"
          "  r-bal-dir  r-small-while-big  r0-while-far  oracle-dir")
    for k in range(K + 1):
        tail = ""
        if k < K:
            # balanced direction recall: the mean of the per-direction
            # recalls over the directions the expert used
            recs = [dir_hits[k, c] / dir_n[k, c] for c in (0, 1)
                    if dir_n[k, c] > 0]
            bal = np.mean(recs) if recs else np.nan
            swb = (small_while_big[k] / big_n[k] if big_n[k] else np.nan)
            tail = (f" | {sign_agree[k] / n_seen:10.2f}"
                    f" {bal:9.2f}"
                    f" {swb:17.2f}"
                    f" {zero_while_far[k] / n_seen:12.2f}"
                    f" {oracle[k]:11.2f}")
        print(f"{k:4d} | {rte[k].mean():7.3f} {rre[k].mean():8.2f}"
              f" | {occ[k].mean():9.0f}{tail}")

    def show_hist(title, hp, he, labels):
        print(f"\n{title} (rows: step; cols: {' '.join(labels)})")
        for k in range(K):
            tot = max(hp[k].sum(), 1)
            pol = " ".join(f"{v / tot:4.0%}" for v in hp[k])
            exp = " ".join(f"{v / tot:4.0%}" for v in he[k])
            print(f"  k={k}  pol {pol}\n       exp {exp}")

    show_hist("rotation head", hist_pol, hist_exp, steps_deg)
    show_hist("translation heads (x+z pooled)", t_hist_pol, t_hist_exp,
              steps_m)
    return {"rte": rte, "rre": rre, "occupancy": occ, "oracle": oracle}


if __name__ == "__main__":
    main()
