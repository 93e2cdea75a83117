"""Episode visualiser: projection overlays and bird's-eye frames of a
registration episode (the JAX package's ``tools/visualize.py``).

:func:`rollout` runs one sample's episode on the device and records each
step's pose estimate, RTE / RRE and action; :func:`render` draws what the
agent experiences from that record, on the host:

* left panel: the camera image with the cloud projected under the current
  pose estimate, coloured by depth (viridis); points leave the frustum as
  the pose goes wrong;
* right panel: bird's-eye view (x/z) of the ground-truth registered cloud
  (gray) under the current estimate's cloud (blue), with the step's RTE
  and RRE in the title.

Policies: ``expert`` (the analytic expert, no weights), ``untrained`` (a
random-weight agent) or ``agent`` (trained checkpoints). Writes
``step-00.png .. step-K.png``, ``episode.gif`` and ``errors.json``::

    python -m cmr_agent_tpu_torch.tools.visualize --dataset synthetic --tiny \\
        --device cpu --out viz                # expert, no weights needed
    python -m cmr_agent_tpu_torch.tools.visualize --dataset kitti \\
        --data-root .. --policy agent --geo-ckpt runs_r4/geo_45 \\
        --agent-ckpt runs_r4/agent_45 --pose-aware --aux-head

matplotlib and Pillow are imported inside the rendering calls only, so the
rollout runs where neither is installed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from .. import serve

# ink tokens for text/grids (never the series colors)
_INK = "#374151"
_MUTED = "#9ca3af"
_CURRENT = "#2f6fed"   # current-estimate cloud (series 1)
_TARGET = "#b0b4bb"    # ground-truth cloud (neutral reference)


def _se3_apply_disentangled(pc, pose, mean):
    """Rotate about the cloud centroid, then translate."""
    R, t = pose[:3, :3], pose[:3, 3]
    return (pc - mean) @ R.T + mean + t


def _project(pc_cam, K):
    z = pc_cam[:, 2]
    uv = pc_cam @ K.T
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = uv[:, :2] / uv[:, 2:3]
    return uv, z


def render_frame(img, pc, K4, pose, mean, pose_tgt, step, rte, rre,
                 action_txt=""):
    """One ``[H, W, 3]`` uint8 frame: overlay + BEV panels."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h, w = img.shape[:2]
    moved = _se3_apply_disentangled(pc, pose, mean)
    uv, z = _project(moved, K4)
    ok = (z > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < w) \
        & (uv[:, 1] >= 0) & (uv[:, 1] < h)

    fig, (ax0, ax1) = plt.subplots(
        1, 2, figsize=(11, 4), dpi=110,
        gridspec_kw={"width_ratios": [1.6, 1.0]})
    fig.patch.set_facecolor("white")

    ax0.imshow(img, interpolation="nearest")
    if ok.any():
        order = np.argsort(-z[ok])     # far first so near points win
        ax0.scatter(uv[ok, 0][order], uv[ok, 1][order], c=z[ok][order],
                    cmap="viridis", s=1.2, linewidths=0,
                    vmin=2.0, vmax=max(40.0, float(np.percentile(z[ok], 95))))
    ax0.set_xlim(0, w)
    ax0.set_ylim(h, 0)
    ax0.set_xticks([])
    ax0.set_yticks([])
    ax0.set_title(f"step {step}: {int(ok.sum())}/{len(pc)} pts in frustum"
                  f"{action_txt}", color=_INK, fontsize=10, loc="left")

    tgt = _se3_apply_disentangled(pc, pose_tgt, mean)
    ax1.scatter(tgt[:, 0], tgt[:, 2], s=1.0, c=_TARGET, linewidths=0,
                label="target (GT pose)")
    ax1.scatter(moved[:, 0], moved[:, 2], s=1.0, c=_CURRENT, linewidths=0,
                label="current estimate")
    ax1.set_aspect("equal")
    ax1.set_title(f"BEV — RTE {rte:.2f} m, RRE {rre:.1f}°",
                  color=_INK, fontsize=10, loc="left")
    ax1.tick_params(colors=_MUTED, labelsize=7)
    for s in ax1.spines.values():
        s.set_color(_MUTED)
    leg = ax1.legend(loc="upper right", fontsize=7, frameon=False,
                     markerscale=6)
    for txt in leg.get_texts():
        txt.set_color(_INK)

    fig.tight_layout()
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


def rollout(cfg, batch, policy: str = "expert", geo_vars=None, agent=None,
            sample: int = 0, device="cuda") -> dict:
    """One episode of sample ``sample`` of the collated numpy ``batch`` on
    ``device``: ``{"poses" [K+1, 4, 4], "rte", "rre" (K+1 each),
    "actions" [(action_r, action_t)] (K), "pose_tgt" [4, 4]}``, numpy.
    ``expert`` drives with the analytic expert from the identity;
    ``agent`` / ``untrained`` run ``agent`` (a ``CMRAgent``) on the
    observations of ``geo_vars`` (``pc_overlap_pred``, ``pc_geo_feat``,
    ``img_geo_feat`` of the sample), from the bearing yaw with
    ``cfg.bearing_init``."""
    from ..env.environment import (apply_action, bearing_init_pose,
                                   expert_action, observation_from_pose)
    from ..env.episode import step_tables
    from ..models.agent import action_from_logits
    from ..ops.geometry import pose_diff, to_disentangled

    dev = serve.resolve_device(device)
    b1 = {k: torch.as_tensor(np.asarray(v[sample:sample + 1])).to(dev)
          for k, v in batch.items()}
    pose_tgt = to_disentangled(b1["P"], b1["pc"])
    pose = torch.eye(4, device=dev)[None].clone()
    r_steps, t_steps = step_tables(cfg, dev)
    if policy in ("agent", "untrained"):
        state = {"pc": b1["pc"], "K": b1["K"]}
        state.update({k: torch.as_tensor(v).to(dev)
                      for k, v in geo_vars.items()})
        if cfg.bearing_init:
            pose = bearing_init_pose(state).float()
        raster_mode = "compact" if cfg.raster_mode == "compact" else "flat"
    elif policy != "expert":
        raise ValueError(f"unknown policy {policy!r}")
    elif cfg.bearing_init:
        print("[visualize] note: --bearing-init only affects the agent/"
              "untrained policies (the analytic expert is pose-fed); "
              "rendering the expert from identity", file=sys.stderr)
    poses, rtes, rres, actions = [], [], [], []
    with torch.no_grad():
        for step in range(cfg.action_num + 1):
            rte, rre = pose_diff(pose, pose_tgt)
            poses.append(pose[0].cpu().numpy())
            rtes.append(float(rte[0]))
            rres.append(float(rre[0]))
            if step == cfg.action_num:
                break
            if policy == "expert":
                ar, at = expert_action(pose, pose_tgt, r_steps, t_steps,
                                       cfg.is_6_dof)
            else:
                obs2d, obs3d = observation_from_pose(
                    state, pose, cfg.image_h, cfg.image_w, None, raster_mode,
                    cfg.pose_aware_observation, cfg.obs_bearing_channels)
                rl, tl, _ = agent(obs2d, obs3d)
                ar, at = action_from_logits(rl, tl, None, True)
            actions.append((ar[0].cpu().numpy(), at[0].cpu().numpy()))
            pose = apply_action(ar, at, pose, r_steps, t_steps, cfg.is_6_dof)
    return {"poses": np.stack(poses), "rte": rtes, "rre": rres,
            "actions": actions, "pose_tgt": pose_tgt[0].cpu().numpy()}


def render(cfg, batch, record: dict, out_dir: str, policy: str,
           sample: int = 0, make_gif: bool = True):
    """Frames, ``episode.gif`` and ``errors.json`` of a :func:`rollout`
    record in ``out_dir``; returns ``[(rte, rre)]`` per step."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    img = np.clip(np.asarray(batch["img"][sample]), 0, 1)
    pc = np.asarray(batch["pc"][sample])
    K4 = np.asarray(batch["K"][sample]).copy()
    K4[:2] *= 4.0                      # K is stored at the 1/4 PnP scale
    mean = pc.mean(axis=0, keepdims=True)
    r_tab = np.asarray(cfg.r_steps_array())
    t_tab = np.asarray(cfg.t_steps_array())
    frames = []
    for step, pose in enumerate(record["poses"]):
        action_txt = ""
        if step < len(record["actions"]):
            a_r, a_t = record["actions"][step]
            action_txt = (f" — action: yaw {r_tab[a_r[0]] * 57.2958:+.1f}°,"
                          f" x {t_tab[a_t[0]]:+.1f} m,"
                          f" z {t_tab[a_t[-1]]:+.1f} m")
        frame = render_frame(img, pc, K4, pose, mean, record["pose_tgt"],
                             step, record["rte"][step], record["rre"][step],
                             action_txt)
        frames.append(frame)
        Image.fromarray(frame).save(os.path.join(out_dir,
                                                 f"step-{step:02d}.png"))
    if make_gif:
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(os.path.join(out_dir, "episode.gif"), save_all=True,
                     append_images=imgs[1:], duration=600, loop=0)
    with open(os.path.join(out_dir, "errors.json"), "w") as f:
        json.dump({"rte": record["rte"], "rre": record["rre"],
                   "policy": policy}, f)
    return list(zip(record["rte"], record["rre"]))


def run_and_render(cfg, batch, out_dir: str, policy: str = "expert",
                   geo_vars=None, agent=None, sample: int = 0,
                   make_gif: bool = True, device="cuda"):
    """:func:`rollout` on ``device`` then :func:`render`; returns
    ``[(rte, rre)]`` per step (K+1, the initial state included)."""
    record = rollout(cfg, batch, policy, geo_vars, agent, sample, device)
    return render(cfg, batch, record, out_dir, policy, sample, make_gif)


def main(argv=None):
    from ..cli.common import (add_common_args, apply_obs_overrides,
                              build_config, build_dataset,
                              load_geo_variables, load_model, to_device)
    from ..data import collate

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(p)
    p.add_argument("--out", default="viz")
    p.add_argument("--policy", choices=["expert", "agent", "untrained"],
                   default="expert")
    p.add_argument("--geo-ckpt", default="",
                   help="weight export, Orbax tree or reference "
                        "geo_feat.pth (agent policy)")
    p.add_argument("--agent-ckpt", default="",
                   help="weight export, Orbax tree or reference agent.pth "
                        "(agent policy)")
    p.add_argument("--sample", type=int, default=0)
    p.add_argument("--mode", default="val", choices=["train", "val", "test"])
    p.add_argument("--pose-aware", action="store_true",
                   help="pose-aware 3-D observation: required for agents "
                        "trained with --pose-aware")
    p.add_argument("--obs-bearing", action="store_true",
                   help="bearing observation channels (as trained)")
    p.add_argument("--aux-head", action="store_true",
                   help="the bearing statistic into the policy/value heads "
                        "(implies --obs-bearing)")
    p.add_argument("--bearing-init", action="store_true",
                   help="start from the yaw that points the predicted-"
                        "overlap sector at the camera axis")
    args = p.parse_args(argv)

    dev = serve.resolve_device(args.device)
    cfg = apply_obs_overrides(build_config(args), args)
    ds = build_dataset(cfg, args, args.mode)
    n = min(len(ds), max(args.sample + 1, 1))
    batch = collate([ds[i] for i in range(n)])

    geo_vars = agent = None
    if args.policy in ("agent", "untrained"):
        from ..models.agent import CMRAgent
        from ..train.train_geo import make_geo_forward

        geo = load_geo_variables(cfg, args, dev)
        out = make_geo_forward(cfg)(geo, to_device(batch, dev))
        geo_vars = {k: out[k][args.sample:args.sample + 1]
                    for k in ("pc_overlap_pred", "pc_geo_feat",
                              "img_geo_feat")}
        ckpt = args.agent_ckpt if args.policy == "agent" else ""
        agent = load_model(cfg, CMRAgent(cfg), ckpt, "agent", "agent", dev)

    errs = run_and_render(cfg, batch, args.out, policy=args.policy,
                          geo_vars=geo_vars, agent=agent,
                          sample=args.sample, device=dev)
    print(json.dumps({"out": args.out, "policy": args.policy,
                      "rte": [round(e[0], 3) for e in errs],
                      "rre": [round(e[1], 3) for e in errs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
