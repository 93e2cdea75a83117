"""The port's ``int8_probe``, ``diagnose_agent`` and ``visualize`` tools
against the JAX package's, on the CPU.

* ``int8_probe``: the three chains (bf16, int8 storage, int8 x int8
  matmul) from the same seed-0 draws give the JAX chains' outputs at a
  small size: the int8 codes equal, the bf16 outputs within one bf16
  rounding; ``main`` runs and projects from its own episode trace.
* ``diagnose_agent``: ``replay_poses`` and ``raster_occupancy`` on the same
  tiny batch and recorded actions as JAX's; the port's ``main`` at the tiny
  size prints the per-step table and both histograms (the JAX ``main`` is
  not run again: ``tests/test_diagnose.py`` holds it).
* ``visualize``: the expert's and an untrained agent's rollouts give the
  per-step errors of JAX's ``errors.json`` (the agents' weights carried
  across by the weight bridge), and the frames and GIF render here.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmr_agent_tpu.config import micro_config as jax_micro_config
from cmr_agent_tpu.config import tiny_config as jax_tiny_config
from cmr_agent_tpu.data import SyntheticDataset as JaxSynthetic, collate
from cmr_agent_tpu.tools import diagnose_agent as jdiag
from cmr_agent_tpu.tools import int8_probe as jprobe
from cmr_agent_tpu.tools import visualize as jviz
from cmr_agent_tpu_torch.config import micro_config, tiny_config
from cmr_agent_tpu_torch.models.agent import CMRAgent
from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
from cmr_agent_tpu_torch.serve import init_random_
from cmr_agent_tpu_torch.tools import diagnose_agent, int8_probe, visualize
from cmr_agent_tpu_torch.train.convert import flax_to_state_dict


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- int8_probe

@pytest.mark.parametrize("name", ["bf16", "int8", "int8mm"])
def test_int8_probe_chains_match_jax(name):
    jx, jfns = jprobe.build_fns(2, 256, 16, 9)
    px, pfns = int8_probe.build_fns(2, 256, 16, 9, "cpu")
    np.testing.assert_array_equal(px.float().numpy(),
                                  np.asarray(jx.astype(jnp.float32)))
    want = np.asarray(jfns[name](jx, jnp.zeros((), jnp.float32))
                      .astype(jnp.float32))
    got = pfns[name](px, torch.zeros(())).float().numpy()
    if name != "bf16":       # the stored codes: k / 16, exactly equal
        np.testing.assert_array_equal(np.round(got * 16), np.round(want * 16))
    # within one bf16 rounding (8 significant bits)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0)


def test_int8_probe_main_projects_from_its_own_trace(capsys):
    out = int8_probe.main(["--device", "cpu", "--batch", "2", "--n", "256",
                           "--f", "16", "--iters", "1", "--config", "micro",
                           "--episode-batch", "2", "--episode-iters", "1"])
    for k in ("bf16_ms", "int8_ms", "int8mm_ms", "episode_ms", "stack_ms"):
        assert out[k] > 0.0, k
    assert 0.0 < out["stack_share"] <= 1.0
    ep, st = out["episode_ms"], out["stack_ms"]
    want = ep / (ep - st + st * out["int8_ms"] / out["bf16_ms"])
    assert out["projected_episode_gain_int8"] == pytest.approx(want)
    assert out["device"] == "cpu" and out["stack_kernels"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out


# --------------------------------------------------------- diagnose_agent

def _diag_inputs():
    """A tiny batch, random recorded actions and overlap flags, for both
    packages."""
    jcfg = jax_tiny_config(train_batch_size=2)
    ds = JaxSynthetic(jcfg, length=2, seed=0, scene="random")
    batch = collate([ds[0], ds[1]])
    rng = np.random.default_rng(0)
    k, n_act = jcfg.action_num, len(jcfg.r_steps_deg)
    traj = {"action_r": rng.integers(0, n_act, (k, 2, 1)),
            "action_t": rng.integers(0, n_act, (k, 2, 2)),
            "expert_action_r": rng.integers(0, n_act, (k, 2, 1)),
            "expert_action_t": rng.integers(0, n_act, (k, 2, 2))}
    overlap = rng.random((2, jcfg.num_pt)) < 0.6
    return jcfg, batch, traj, overlap


def test_replay_poses_matches_jax():
    jcfg, batch, traj, _ = _diag_inputs()
    want_rte, want_rre, want_pose = jdiag.replay_poses(
        jcfg, {k: jnp.asarray(v) for k, v in traj.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    got_rte, got_rre, got_pose = diagnose_agent.replay_poses(
        tiny_config(train_batch_size=2), traj,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got_rte.shape == (jcfg.action_num + 1, 2)
    np.testing.assert_allclose(got_rte, want_rte, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_rre, want_rre, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got_pose.numpy(), np.asarray(want_pose),
                               rtol=1e-5, atol=1e-4)


def test_raster_occupancy_matches_jax():
    jcfg, batch, traj, overlap = _diag_inputs()
    geo = {"pc": batch["pc"], "pc_overlap_pred": overlap}
    want = jdiag.raster_occupancy(
        jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in geo.items()}, None,
        {k: jnp.asarray(v) for k, v in traj.items()})
    got = diagnose_agent.raster_occupancy(
        tiny_config(train_batch_size=2),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        {k: torch.from_numpy(np.asarray(v)) for k, v in geo.items()}, None,
        traj)
    for g, w in zip(got, want):         # counts, oracle hits, oracle n
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].sum() > 0


@pytest.fixture(scope="module")
def geo_pth(tmp_path_factory):
    """A tiny geo model's random weights as a reference-layout ``.pth``."""
    m = MultiHeadModel(tiny_config(train_batch_size=2))
    init_random_(m, torch.Generator().manual_seed(0))
    path = tmp_path_factory.mktemp("diag") / "geo.pth"
    torch.save(m.state_dict(), path)
    return str(path)


@pytest.mark.parametrize("extra", [[], ["--pose-aware", "--bearing-init"]])
def test_diagnose_main_prints_the_per_step_table(geo_pth, capsys, extra):
    import re
    cfg = tiny_config()
    out = diagnose_agent.main(["--geo-ckpt", geo_pth, "--pool-size", "2",
                               "--batch-size", "2", "--scene", "random",
                               "--device", "cpu"] + extra)
    text = capsys.readouterr().out
    rows = re.findall(r"^\s*(\d+) \|", text, flags=re.M)
    assert len(rows) == cfg.action_num + 1
    assert text.count("pol ") == 2 * cfg.action_num
    assert text.count("exp ") == 2 * cfg.action_num
    first = re.search(r"^\s*0 \|\s+([\d.]+)\s+([\d.]+)", text, flags=re.M)
    assert first and np.isfinite(float(first.group(1)))
    assert out["rte"].shape == (cfg.action_num + 1, 2)
    np.testing.assert_allclose(float(first.group(1)), out["rte"][0].mean(),
                               atol=5e-4)


def test_diagnose_refuses_a_missing_checkpoint(tmp_path):
    with pytest.raises(Exception):
        diagnose_agent.main(["--geo-ckpt", str(tmp_path / "nope"),
                             "--pool-size", "2", "--batch-size", "2",
                             "--scene", "random", "--device", "cpu"])


# -------------------------------------------------------------- visualize

def test_expert_rollout_matches_jax_and_renders(tmp_path):
    """The expert's per-step errors as JAX's ``errors.json`` (within 1e-4),
    descending; every frame and the GIF written."""
    jcfg = jax_micro_config(action_num=6)
    batch = collate([JaxSynthetic(jcfg, length=1, seed=3)[0]])
    jviz.run_and_render(jcfg, batch, str(tmp_path / "jax"), policy="expert",
                        make_gif=False)
    want = json.load(open(tmp_path / "jax" / "errors.json"))
    cfg = micro_config(action_num=6)
    out = str(tmp_path / "port")
    errs = visualize.run_and_render(cfg, batch, out, policy="expert",
                                    make_gif=True, device="cpu")
    np.testing.assert_allclose([e[0] for e in errs], want["rte"],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose([e[1] for e in errs], want["rre"],
                               rtol=1e-5, atol=1e-3)
    assert errs[-1][0] < errs[0][0] and errs[-1][1] < errs[0][1]
    for step in range(cfg.action_num + 1):
        assert os.path.exists(os.path.join(out, f"step-{step:02d}.png"))
    assert os.path.exists(os.path.join(out, "episode.gif"))
    rec = json.load(open(os.path.join(out, "errors.json")))
    assert rec["policy"] == "expert" and rec["rte"] == [e[0] for e in errs]


def test_untrained_agent_rollout_matches_jax(tmp_path):
    """The agent policy (observation -> CMRAgent -> argmax) with JAX's
    random-init agent carried across: the same actions, so the same
    per-step errors as JAX's ``errors.json``."""
    from cmr_agent_tpu.train import create_agent_state
    jcfg = jax_micro_config(action_num=2)
    batch = collate([JaxSynthetic(jcfg, length=1, seed=5)[0]])
    rng = np.random.default_rng(0)
    n, f, h, w = jcfg.num_pt, jcfg.embed_dim, jcfg.image_h, jcfg.image_w
    geo_np = {"pc_overlap_pred": rng.integers(0, 2, (1, n)).astype(bool),
              "pc_geo_feat": rng.normal(size=(1, n, f)).astype(np.float32),
              "img_geo_feat": rng.normal(size=(1, h, w, f)).astype(
                  np.float32)}
    state = create_agent_state(jcfg, jnp.zeros((1, h, w, 2 * f)),
                               jnp.zeros((1, n, 5)), jax.random.key(0))
    jviz.run_and_render(jcfg, batch, str(tmp_path / "jax"),
                        policy="untrained",
                        geo_vars={k: jnp.asarray(v)
                                  for k, v in geo_np.items()},
                        agent_state=state, make_gif=False)
    want = json.load(open(tmp_path / "jax" / "errors.json"))
    cfg = micro_config(action_num=2)
    agent = CMRAgent(cfg)
    agent.load_state_dict(flax_to_state_dict(cfg, {
        "params": jax.tree_util.tree_map(np.asarray, state.params),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              state.batch_stats)}, "agent"))
    record = visualize.rollout(cfg, batch, "untrained",
                               {k: torch.from_numpy(v)
                                for k, v in geo_np.items()},
                               agent.eval(), device="cpu")
    np.testing.assert_allclose(record["rte"], want["rte"], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(record["rre"], want["rre"], rtol=1e-5,
                               atol=1e-3)
    assert len(record["actions"]) == cfg.action_num
    with pytest.raises(ValueError, match="policy"):
        visualize.rollout(cfg, batch, "random", device="cpu")
