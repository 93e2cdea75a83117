"""The port's convergence demo (``cmr_agent_tpu_torch/examples/
convergence_demo.py``) against the JAX package's ``examples/
convergence_demo.py``, on the CPU.

* The JAX demo's three argv sets (``tests/test_convergence_demo.py``)
  through the port's ``main`` with the same asserts. The geo-only sets run
  with the module's ``tiny_config`` swapped for ``micro_config``. The set
  that trains the agent runs at the demo's own tiny config, as the JAX
  test does: at the micro size (3-step episodes) neither package's demo
  passes its own behaviour-cloning assert (0% expert agreement before and
  after 6 agent steps, in the JAX demo as in the port's).
* The flags and the parser's errors are the JAX demo's.
* ``make_pool`` array for array against the JAX demo's recipe with the
  JAX package's ``SyntheticDataset`` / ``DataLoader`` / ``collate``
  (``examples/convergence_demo.py:299-332``): plain, scaled, mixture and
  the unshuffled held-out pool, bit-equal.
* ``eval_expert``, ``eval_agent`` (the validation episodes and their
  aggregation), ``eval_agreement`` and ``geo_holdout_overlap`` against the
  JAX package's env functions, ``make_val_episode_fn`` and
  ``matching_inlier_ratio`` with the JAX demo's aggregation, on the port's
  random weights bridged to the JAX layout
  (``convert.state_dict_to_flax``). Tolerances as in
  ``tests/test_torch_train_agent.py`` (pose errors 1e-5 m / 1e-3 deg of
  the same poses, an episode's final pose 1e-4) and
  ``tests/test_torch_geo.py`` (geo outputs 1e-4).
* The snapshot score: the median selection and the NaN guard.
"""

import argparse
import contextlib
import dataclasses
import io
import os
import re
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmr_agent_tpu.config import micro_config as jax_micro_config
from cmr_agent_tpu.data import DataLoader as JaxDataLoader
from cmr_agent_tpu.data import SyntheticDataset as JaxSyntheticDataset
from cmr_agent_tpu.data import collate as jax_collate
from cmr_agent_tpu.env import apply_action as jax_apply_action
from cmr_agent_tpu.env import bearing_init_pose as jax_bearing_init
from cmr_agent_tpu.env import expert_action as jax_expert_action
from cmr_agent_tpu.env import init_poses as jax_init_poses
from cmr_agent_tpu.env import run_episode as jax_run_episode
from cmr_agent_tpu.models import CMRAgent as JaxAgent
from cmr_agent_tpu.models.multi_head import \
    matching_inlier_ratio as jax_matching_inlier_ratio
from cmr_agent_tpu.ops import pose_diff as jax_pose_diff
from cmr_agent_tpu.ops import to_disentangled as jax_to_disentangled
from cmr_agent_tpu.train import train_agent as jax_train_agent
from cmr_agent_tpu.train.train_geo import make_geo_forward as jax_geo_forward
from cmr_agent_tpu_torch.config import micro_config
from cmr_agent_tpu_torch.examples import convergence_demo as demo
from cmr_agent_tpu_torch.train import checkpoint
from cmr_agent_tpu_torch.train.convert import state_dict_to_flax
from cmr_agent_tpu_torch.train.train_agent import (create_agent_state,
                                                   make_val_episode_fn)
from cmr_agent_tpu_torch.train.train_geo import (create_geo_state,
                                                 make_geo_forward)

REPO = Path(__file__).resolve().parents[1]
B = 2
FLAGSHIP = ["--pose-aware", "--aux-head", "--bearing-init"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def micro_demo(monkeypatch):
    monkeypatch.setattr(demo, "tiny_config", micro_config)


def _jax_demo():
    sys.path.insert(0, str(REPO))
    from examples import convergence_demo
    return convergence_demo


# --------------------------------------------------------------------------
# the JAX demo's argv sets
# --------------------------------------------------------------------------

def test_demo_refresh_curriculum_heldout_val(tmp_path):
    save = str(tmp_path / "agent_best")
    r = demo.main(["--geo-steps", "4", "--agent-steps", "6", "--batch-size",
                   "2", "--pool-size", "4", "--refresh-every", "2",
                   "--geo-refresh-every", "2", "--curriculum", "0.5",
                   "--val-size", "4", "--scene", "structured",
                   "--amp-mixture", "--expert-beta-floor", "0.2",
                   "--pose-aware", "--lr-epoch-steps", "50",
                   "--val-every", "2", "--obs-bearing", "--select-median",
                   "--save-agent", save, "--device", "cpu"])
    # the best snapshot was persisted (a stepless snapshot of the port)
    assert os.path.isdir(save)
    assert checkpoint.saved_tree_keys(save) == {"module"}
    # geo descended, BC raised expert agreement (asserted inside main too)
    assert r["geo_losses"][-1] < r["geo_losses"][0]
    u_agree, t_agree = r["agreement"]
    assert t_agree > u_agree
    # held-out eval produced finite full-amplitude metrics
    for k in ("untrained", "trained", "expert"):
        rte, rre = r[k]
        assert rte >= 0 and rre >= 0
    assert sorted(r) == ["agreement", "bc", "expert", "geo_losses",
                         "trained", "untrained"]


def test_demo_geo_curriculum_and_warm_start(micro_demo, tmp_path, capsys):
    geo_dir = str(tmp_path / "geo_cur")
    r = demo.main(["--geo-steps", "4", "--agent-steps", "0", "--batch-size",
                   "2", "--pool-size", "4", "--val-size", "2", "--scene",
                   "structured", "--geo-refresh-every", "2",
                   "--geo-curriculum", "0.5", "--geo-r-start", "0.3",
                   "--save-geo", geo_dir, "--device", "cpu"])
    assert os.path.isdir(geo_dir)
    assert np.isfinite(r["geo_losses"]).all()
    assert sorted(r) == ["geo_holdout", "geo_losses"]
    assert "train-r-amp" not in capsys.readouterr().out  # no val in 4 steps
    # warm-start: losses continue from the snapshot (a fresh list, still
    # finite), held-out eval runs at full amplitude
    r2 = demo.main(["--geo-steps", "2", "--agent-steps", "0", "--batch-size",
                    "2", "--pool-size", "4", "--val-size", "2", "--scene",
                    "structured", "--load-geo", geo_dir, "--geo-warm-start",
                    "--device", "cpu"])
    assert len(r2["geo_losses"]) == 2
    assert np.isfinite(r2["geo_losses"]).all()
    # plain --load-geo (no warm start) still skips stage 1 and evaluates
    # the snapshot's weights
    r3 = demo.main(["--geo-steps", "2", "--agent-steps", "0", "--batch-size",
                    "2", "--pool-size", "4", "--val-size", "2", "--scene",
                    "structured", "--load-geo", geo_dir, "--device", "cpu"])
    assert len(r3["geo_losses"]) == 1 and np.isnan(r3["geo_losses"][0])
    assert r3["geo_holdout"] == r["geo_holdout"]


def test_demo_embed_dim_override_geo_only(micro_demo, tmp_path):
    geo_dir = str(tmp_path / "geo_best")
    r = demo.main(["--geo-steps", "3", "--agent-steps", "0", "--batch-size",
                   "2", "--pool-size", "4", "--val-size", "2", "--scene",
                   "structured", "--embed-dim", "48", "--mlp-dim", "96",
                   "--save-geo", geo_dir, "--device", "cpu"])
    assert len(r["geo_losses"]) == 3
    assert np.isfinite(r["geo_losses"]).all()
    # --save-geo with a held-out pool keeps the best snapshot (final
    # state here, since no val checkpoint fires in 3 steps)
    assert os.path.isdir(geo_dir)
    sd = checkpoint.restore_state_dict(
        geo_dir, micro_config(embed_dim=48, mlp_dim=96), "multihead")
    assert all(torch.isfinite(v).all() for v in sd.values()
               if v.is_floating_point())


def test_flags_are_the_jax_demos():
    """Every flag of the JAX demo, and ``--device`` besides."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        _jax_demo().main(["--help"])
    flags = lambda text: set(re.findall(r"(--[a-z][a-z0-9-]*)", text))
    assert flags(demo.parser().format_help()) == flags(buf.getvalue()) | {
        "--device"}


@pytest.mark.parametrize("argv", [
    ["--select-median"],
    ["--geo-curriculum", "0.5"],
    ["--geo-warm-start"],
])
def test_parser_errors_are_the_jax_demos(argv, capsys):
    with pytest.raises(SystemExit) as want:
        _jax_demo().main(argv)
    want_err = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        demo.main(argv + ["--device", "cpu"])
    got_err = capsys.readouterr().err.splitlines()[-1]
    assert got.value.code == want.value.code == 2
    assert got_err.split("error: ")[1] == want_err.split("error: ")[1]


def test_curriculum_scales():
    args = argparse.Namespace(geo_curriculum=0.5, geo_steps=10,
                              geo_r_start=0.3, curriculum=0.5,
                              agent_steps=20, expert_beta_frac=0.5,
                              expert_beta_floor=0.2)
    cfg = micro_config(p_ry_amplitude=1.2)
    assert [demo.geo_r_scale(cfg, args, i) for i in (0, 5, 9)] == \
        pytest.approx([0.25, 1.0, 1.0])
    assert demo.geo_r_scale(cfg, args, 2) == pytest.approx(0.25 + 0.75 * 0.4)
    assert [demo.cur_scale(args, i) for i in (0, 5, 10)] == \
        pytest.approx([0.15, 0.575, 1.0])
    assert [demo.expert_beta(args, i) for i in (0, 5, 9)] == \
        pytest.approx([1.0, 0.5, 0.2])
    floor_only = argparse.Namespace(**{**vars(args), "expert_beta_frac": 0})
    assert demo.expert_beta(floor_only, 3) == 0.2
    assert demo.expert_beta(argparse.Namespace(
        expert_beta_frac=0.0, expert_beta_floor=0.0, agent_steps=5), 0) \
        is None


# --------------------------------------------------------------------------
# pools
# --------------------------------------------------------------------------

def _jax_scaled(jcfg, scale, r_scale):
    """The JAX demo's ``scaled_cfg`` (examples/convergence_demo.py:274)."""
    rs = scale if r_scale is None else r_scale
    if scale >= 1.0 and rs >= 1.0:
        return jcfg
    return dataclasses.replace(
        jcfg, p_tx_amplitude=jcfg.p_tx_amplitude * scale,
        p_ty_amplitude=jcfg.p_ty_amplitude * scale,
        p_tz_amplitude=jcfg.p_tz_amplitude * scale,
        p_rx_amplitude=jcfg.p_rx_amplitude * rs,
        p_ry_amplitude=jcfg.p_ry_amplitude * rs,
        p_rz_amplitude=jcfg.p_rz_amplitude * rs)


def _jax_pool(jcfg, length, *, seed, epoch=0, scale=1.0, r_scale=None,
              shuffle=True, mixture=False, scene="structured"):
    """The JAX demo's ``make_pool`` (examples/convergence_demo.py:299-332)
    on numpy batches."""
    if not mixture:
        ds = JaxSyntheticDataset(_jax_scaled(jcfg, scale, r_scale),
                                 length=length, seed=seed, scene=scene)
        ds.set_epoch(epoch)
        return list(JaxDataLoader(ds, B, shuffle=shuffle, num_workers=0,
                                  seed=seed + epoch))
    rng = np.random.default_rng((seed, epoch, 77))
    samples = []
    for i in range(length):
        t_s = float(rng.choice(demo.T_MIX))
        r_s = float(rng.choice(demo.R_MIX))
        ds = JaxSyntheticDataset(_jax_scaled(jcfg, t_s, r_s), length=length,
                                 seed=seed, scene=scene)
        ds.set_epoch(epoch)
        samples.append(ds[i])
    order = rng.permutation(length) if shuffle else np.arange(length)
    return [jax_collate([samples[j] for j in order[s:s + B]])
            for s in range(0, length - B + 1, B)]


def _demo_config(*flags):
    args = demo.parse_args(["--batch-size", str(B), "--scene", "structured",
                            "--device", "cpu", *flags])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(demo, "tiny_config", micro_config)
        cfg, host_ops = demo.build_config(args)
    jcfg = jax_micro_config(train_batch_size=B, num_trajectory=2,
                            ppo_batch_size=8,
                            **{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(cfg)
                               if f.name in ("pose_aware_observation",
                                             "obs_bearing_channels",
                                             "policy_aux_state",
                                             "bearing_init")})
    return args, cfg, jcfg


@pytest.mark.parametrize("kind, kw", [
    ("plain", dict(seed=0)),
    ("scaled", dict(seed=1000, epoch=2, scale=0.5, r_scale=0.3)),
    ("mixture", dict(seed=0, epoch=1, mixture=True)),
    ("held_out", dict(seed=demo.VAL_SEED, shuffle=False)),
])
def test_make_pool_is_the_jax_demos(kind, kw):
    args, cfg, jcfg = _demo_config()
    got = demo.make_pool(cfg, args, 6, **kw)
    want = _jax_pool(jcfg, 6, **kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].device.type == "cpu"
            a = g[k].numpy()
            assert a.dtype == w[k].dtype, k
            np.testing.assert_array_equal(a, w[k], err_msg=f"{kind} {k}")


# --------------------------------------------------------------------------
# evaluation against the JAX package
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["plain", "flagship"])
def bridged(request):
    """A held-out micro pool, the port's random geo model and agent, the
    agent's weights in the JAX layout, the geo outputs on each batch, and
    the JAX demo's agent state of those weights."""
    flags = FLAGSHIP if request.param == "flagship" else []
    args, cfg, jcfg = _demo_config(*flags)
    pool = demo.make_pool(cfg, args, 4, seed=demo.VAL_SEED, shuffle=False)
    geo = create_geo_state(cfg, "cpu", seed=0).model
    agent_state = create_agent_state(cfg, "cpu", seed=1)
    fwd = make_geo_forward(cfg)
    outs = [fwd(geo, b) for b in pool]
    av = state_dict_to_flax(cfg, agent_state.agent.state_dict(), "agent")
    jstate = jax_train_agent.AgentTrainState(
        step=jnp.zeros((), jnp.int32), params=av["params"],
        batch_stats=av["batch_stats"], opt_state=None, tx=None,
        apply_fn=JaxAgent(jcfg).apply)
    return dict(args=args, cfg=cfg, jcfg=jcfg, pool=pool, geo=geo,
                agent_state=agent_state, fwd=fwd, outs=outs, jstate=jstate)


def _np(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _jax_geo_out(out):
    return {k: jnp.asarray(v.numpy()) for k, v in out.items()
            if isinstance(v, torch.Tensor)}


def test_eval_expert_is_the_jax_demos(bridged):
    """The expert's floor over the pool (examples/convergence_demo.py:
    714-727): the JAX env functions on the same batches."""
    cfg, jcfg = bridged["cfg"], bridged["jcfg"]
    r_steps = jnp.asarray(jcfg.r_steps_array())
    t_steps = jnp.asarray(jcfg.t_steps_array())
    rte_all, rre_all = [], []
    for batch in map(_np, bridged["pool"]):
        pose, tgt = jax_init_poses(batch)
        tgt = jax_to_disentangled(tgt, batch["pc"])
        for _ in range(jcfg.action_num):
            ar, at = jax_expert_action(pose, tgt, r_steps, t_steps)
            pose = jax_apply_action(ar, at, pose, r_steps, t_steps)
        rte, rre = jax_pose_diff(pose, tgt)
        rte_all += np.asarray(rte).tolist()
        rre_all += np.asarray(rre).tolist()
    got = demo.eval_expert(cfg, bridged["pool"])
    assert got[0] == pytest.approx(np.mean(rte_all), abs=1e-5)
    assert got[1] == pytest.approx(np.mean(rre_all), abs=1e-3)
    assert 0 < got[0] < 5 and 0 <= got[1] < 10


def _jax_stats(rte_all, rre_all):
    """The JAX demo's ``eval_agent`` aggregation (:558-571)."""
    rte_a, rre_a = np.asarray(rte_all), np.asarray(rre_all)
    stats = {"median_rte": float(np.median(rte_a)),
             "median_rre": float(np.median(rre_a)),
             "solved": int(((rre_a < 10.0) & (rte_a < 5.0)).sum()),
             "n": len(rte_a)}
    return float(np.mean(rte_all)), float(np.mean(rre_all)), stats


def test_eval_agent_is_the_jax_demos(bridged):
    """The deterministic validation episodes on the same geo outputs and
    agent weights, through the JAX package's ``make_val_episode_fn``, and
    the demo's aggregation: per-sample RTE within 1e-4 m and RRE within
    1e-2 deg (the final poses' 1e-4), the same solved count."""
    cfg, jcfg = bridged["cfg"], bridged["jcfg"]
    outs = iter(bridged["outs"])
    got = demo.eval_agent(make_val_episode_fn(cfg), lambda geo, b: next(outs),
                          bridged["geo"], bridged["agent_state"],
                          bridged["pool"])
    jval = jax_train_agent.make_val_episode_fn(jcfg)
    rte_all, rre_all = [], []
    for out, batch in zip(bridged["outs"], bridged["pool"]):
        _, rte, rre = jval(bridged["jstate"], _jax_geo_out(out), _np(batch))
        rte_all += np.asarray(rte).tolist()
        rre_all += np.asarray(rre).tolist()
    want = _jax_stats(rte_all, rre_all)
    assert got[0] == pytest.approx(want[0], abs=1e-4)
    assert got[1] == pytest.approx(want[1], abs=1e-2)
    assert got[2]["solved"] == want[2]["solved"]
    assert got[2]["n"] == want[2]["n"] == 4
    assert got[2]["median_rte"] == pytest.approx(want[2]["median_rte"],
                                                 abs=1e-4)
    assert got[2]["median_rre"] == pytest.approx(want[2]["median_rre"],
                                                 abs=1e-2)


def test_eval_agreement_is_the_jax_demos(bridged):
    """``rollout_det`` (a deterministic episode with the expert, the
    bearing yaw honoured) and the agreement over the pool against the JAX
    demo's ``rollout_det`` (:532-547) and ``eval_agreement`` (:700-712):
    the same actions and expert labels at every step."""
    cfg, jcfg, jstate = bridged["cfg"], bridged["jcfg"], bridged["jstate"]
    agree, total = 0, 0
    for out, batch in zip(bridged["outs"], bridged["pool"]):
        jb, jo = _np(batch), _jax_geo_out(out)
        state = jax_train_agent._episode_state(jo, jb)
        pose_src, pose_tgt = jax_init_poses(state)
        if jcfg.bearing_init:
            pose_src = jax_bearing_init(state)
        pose_tgt = jax_to_disentangled(pose_tgt, state["pc"])
        want = jax_run_episode(
            lambda v, o2, o3: jstate.apply_fn(v, o2, o3, train=False),
            {"params": jstate.params, "batch_stats": jstate.batch_stats},
            state, pose_src, pose_tgt, jcfg, deterministic=True,
            with_expert=True, collect_trajectory=True)[1]
        got = demo.rollout_det(cfg, bridged["agent_state"], out, batch)
        for k in ("action_r", "action_t", "expert_action_r",
                  "expert_action_t"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        for k in ("r", "t"):
            a = np.asarray(want[f"action_{k}"])
            agree += (a == np.asarray(want[f"expert_action_{k}"])).sum()
            total += a.size
    outs = iter(bridged["outs"])
    assert demo.eval_agreement(cfg, lambda geo, b: next(outs),
                               bridged["geo"], bridged["agent_state"],
                               bridged["pool"]) == agree / total


def test_geo_holdout_overlap_is_the_jax_demos(bridged):
    """Held-out accuracy, prediction rate, gt rate and IR (:359-390): the
    JAX geo forward on the port's weights bridged to the JAX layout, then
    the JAX demo's recipe with ``matching_inlier_ratio`` vmapped, against
    the port's forward and ``geo_holdout_overlap``. The geo outputs agree
    within 1e-4, so the overlap flags and the inlier counts are equal."""
    cfg, jcfg, geo = bridged["cfg"], bridged["jcfg"], bridged["geo"]
    gv = state_dict_to_flax(cfg, geo.state_dict(), "multihead")
    jfwd = jax_geo_forward(jcfg)
    ir_fn = jax.jit(jax.vmap(
        lambda pf, imf, m, xy: jax_matching_inlier_ratio(
            pf, imf, m, xy, jcfg.image_w, jcfg.image_h)))
    accs, rates, gts, irs = [], [], [], []
    for vb, out in zip(map(_np, bridged["pool"]), bridged["outs"]):
        jout = jfwd(gv["params"], gv["batch_stats"], vb)
        np.testing.assert_allclose(out["pc_geo_feat"].numpy(),
                                   np.asarray(jout["pc_geo_feat"]),
                                   atol=1e-4)
        pred = np.asarray(jout["pc_overlap_pred"])
        gt = np.asarray(vb["pc_mask"]).astype(bool)
        accs.append((pred == gt).mean())
        rates.append(pred.mean())
        gts.append(gt.mean())
        irs.append(float(np.mean(np.asarray(ir_fn(
            jout["pc_geo_feat"], jout["img_geo_feat"],
            jnp.asarray(vb["pc_mask"]).astype(bool),
            vb["point_xy_float_all"])))))
    want = (float(np.mean(accs)), float(np.mean(rates)),
            float(np.mean(gts)), float(np.mean(irs)))
    got = demo.geo_holdout_overlap(cfg, make_geo_forward(cfg), geo,
                                   bridged["pool"])
    assert got[:3] == want[:3]
    assert got[3] == pytest.approx(want[3], abs=1e-7)
    assert 0 < got[2] < 1 and got[3] > 0
    assert demo.geo_holdout_overlap(cfg, None, geo, None) is None


# --------------------------------------------------------------------------
# snapshot selection
# --------------------------------------------------------------------------

def test_select_score_median_and_nan_guard():
    stats = {"solved": 3, "median_rre": 2.0, "median_rte": 0.5}
    best = (np.inf, np.inf)
    assert demo.select_score(1.0, 8.0, stats, True, best) == (-3, 3.0)
    assert demo.select_score(1.0, 8.0, stats, False, best) == (0, 10.0)
    # more solved scenes win over a better median score
    assert demo.select_score(9.0, 90.0, {**stats, "solved": 4}, True,
                             best) < (-3, 0.0)
    # a diverged validation never wins: (0, nan) < (inf, inf) would be
    # True on the first element
    assert demo.select_score(float("nan"), 1.0, stats, False, best) == best
    assert demo.select_score(1.0, 1.0, {**stats, "median_rte": np.nan},
                             True, (-2, 5.0)) == (-2, 5.0)
    assert not demo.select_score(np.nan, 1.0, stats, False, best) < best
    mean, _, s = demo.episode_stats([1.0, 6.0, 2.0], [5.0, 1.0, 20.0])
    assert s == {"median_rte": 2.0, "median_rre": 5.0, "solved": 1, "n": 3}
    assert mean == pytest.approx(3.0)
