"""Evaluate the one-shot geo model and the cost-volume pose head
(counterpart of the JAX package's ``cli/test_geo.py``; reference
Test_Geo.py).

Per sample: geo forward -> matching inlier ratio (feature-NN, <= 3 px) ->
``--iters`` IterModel cost-volume iterations -> RTE / RRE of the
accumulated pose against the ground truth.

Usage::

    python -m cmr_agent_tpu_torch.cli.test_geo --dataset synthetic \\
        --synthetic-scene structured --geo-ckpt runs_r4/geo_pi \\
        --iter-ckpt checkpoint/iter_kitti/epoch-1-step-10000 --unmasked-warp
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.cost_volume import IterModel
from ..models.multi_head import matching_inlier_ratio
from ..ops.geometry import pose_diff
from ..serve import resolve_device
from ..train.train_geo import make_geo_forward
from ..train.train_iter import iter_model_state
from .common import (add_common_args, apply_obs_overrides, build_config,
                     build_dataset, load_geo_variables, load_model,
                     make_loader, require_batches, set_seed,
                     to_device, maybe_initialize_distributed)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(p)
    p.add_argument("--geo-ckpt", default="")
    p.add_argument("--iter-ckpt", default="",
                   help="IterModel checkpoint (a weight export or the Orbax "
                        "tree it came from)")
    p.add_argument("--iters", type=int, default=1,
                   help="cost-volume refinement iterations")
    p.add_argument("--unmasked-warp", action="store_true",
                   help="warp ALL points (Config.cost_volume_unmasked); "
                        "must match how the IterModel ckpt was trained")
    p.add_argument("--max-batches", type=int, default=0)
    p.add_argument("--t-amp", type=float, default=None,
                   help="translation perturbation amplitude override (m)")
    p.add_argument("--r-amp", type=float, default=None,
                   help="yaw perturbation amplitude override (rad)")
    args = p.parse_args(argv)
    maybe_initialize_distributed(args)
    dev = resolve_device(args.device)

    cfg = apply_obs_overrides(build_config(args), args)
    set_seed(cfg.seed)

    test_ds = build_dataset(cfg, args, "test")
    loader = make_loader(cfg, args, test_ds, batch_size=1)
    require_batches(loader)

    geo = load_geo_variables(cfg, args, dev)
    geo_forward = make_geo_forward(cfg)
    iter_model = load_model(cfg, IterModel(cfg), args.iter_ckpt, "itermodel",
                            "iter", dev)

    irs, rtes, rres = [], [], []
    with torch.no_grad():
        for i, batch in enumerate(loader):
            batch = to_device(batch, dev)
            geo_out = geo_forward(geo, batch)
            irs.append(float(matching_inlier_ratio(
                geo_out["pc_geo_feat"][0], geo_out["img_geo_feat"][0],
                batch["pc_mask"][0].bool(), batch["point_xy_float_all"][0],
                cfg.image_w, cfg.image_h)))

            state = iter_model_state(geo_out, batch)
            for _ in range(args.iters):
                out = iter_model(state, with_loss=False)
                state = dict(state, pc_i=out["pc_i"],
                             matrix_accumulated=out["matrix_accumulated"])
            # the accumulated pose maps the perturbed cloud back toward the
            # camera frame: compare it with the inverse perturbation P
            rte, rre = pose_diff(state["matrix_accumulated"], batch["P"])
            rtes += rte.cpu().tolist()
            rres += rre.cpu().tolist()
            if args.max_batches and i + 1 >= args.max_batches:
                break

    result = {
        "matching_inlier_ratio": float(np.mean(irs)),
        "cost_volume_rte_mean": float(np.mean(rtes)),
        "cost_volume_rre_mean": float(np.mean(rres)),
        "num_samples": len(irs),
    }
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
