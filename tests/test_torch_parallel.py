"""The port's ``parallel/`` package, ``data.shard_batch``, the CLIs'
distributed flags and ``--debug-nans``, on the CPU.

The multi-process checks run two ``python -c`` workers over gloo on
127.0.0.1 (a fresh port, retried on a clash as the JAX package's
``_run_pair_retry`` does). The workers import only torch and the port
(JAX and the JAX package are blocked in them); they join the job through
the CLIs' ``maybe_initialize_distributed`` and write what they computed
to ``.pt`` files, which this process holds against the port's
single-process results and the JAX package's. What they show:

* the dp geo train step on 2 ranks (2 rows each, dropout on) is the
  single-process step on the 4 rows: step-0 loss within rtol 1e-6, both
  losses and the parameter checksum after two steps within rtol 5e-5 (the
  JAX package's ``tests/test_distributed.py`` bounds), the P/R/A metrics
  and the BatchNorm running stats the global batch's, equal on both ranks;
  and the per-rank statistics of a plain data-parallel wrap would miss
  those bounds on these inputs;
* under dp the deterministic val episode and one SGD PPO update match
  the single process's (rtol 1e-4, the JAX package's
  ``tests/test_parallel.py`` bounds);
* the sp linear-attention message and the ``LinearAttention`` module on 2
  ranks equal JAX's unsharded message and module within rtol 1e-5, and the
  sharded geo forward (dp or sp) the unsharded one.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmr_agent_tpu.models.linear_attention import \
    LinearAttention as JaxLinearAttention
from cmr_agent_tpu.parallel.sp import \
    linear_attention_message as jax_message
from cmr_agent_tpu_torch import serve
from cmr_agent_tpu_torch.cli import common
from cmr_agent_tpu_torch.config import micro_config
from cmr_agent_tpu_torch.data import shard_batch
from cmr_agent_tpu_torch.env import buffer
from cmr_agent_tpu_torch.models.layers import BatchNorm, set_dropout_rate
from cmr_agent_tpu_torch.models.linear_attention import LinearAttention
from cmr_agent_tpu_torch.parallel import distributed, mesh as pmesh
from cmr_agent_tpu_torch.parallel.sp import linear_attention_message
from cmr_agent_tpu_torch.train import train_agent, train_geo

REPO = Path(__file__).resolve().parents[1]
B = 4                                   # global batch, 2 rows a rank
LA_SHAPE = dict(b=2, l=64, s=40, c=32, heads=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WORKER = textwrap.dedent("""
    import sys

    class _Blocked:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "orbax", "cmr_agent_tpu"):
                raise ImportError(f"worker imported {name}")
            return None
    sys.meta_path.insert(0, _Blocked())

    import torch
    torch.set_num_threads(1)
    port, pid, io = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    inp = torch.load(f"{io}/inputs.pt", weights_only=False)

    import argparse
    from cmr_agent_tpu_torch.cli import common
    p = common.add_common_args(argparse.ArgumentParser())
    args = p.parse_args(["--device", "cpu", "--distributed", "--coordinator",
                         f"127.0.0.1:{port}", "--num-processes", "2",
                         "--process-id", str(pid)])
    common.maybe_initialize_distributed(args)

    from cmr_agent_tpu_torch.parallel import distributed as D, mesh as M
    from cmr_agent_tpu_torch.parallel.sp import sp_linear_attention_message
    from cmr_agent_tpu_torch.models.linear_attention import LinearAttention
    from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
    from cmr_agent_tpu_torch.train import train_agent, train_geo
    out = {"rank": D.process_index(), "world": D.process_count(),
           "shard_range": list(D.shard_range(10)),
           "psum": D.psum_scalar(pid + 1.0),
           "global_batch": D.global_batch_size(3)}
    D.barrier("start", timeout_s=120)
    dp = M.make_mesh((2,), ("dp",), device="cpu")
    sp = M.make_mesh((1, 2), ("dp", "sp"), device="cpu")
    out["dp_coords"] = (dp.rank("dp"), dp.size("dp"))
    out["sp_coords"] = (sp.rank("sp"), sp.size("sp"), sp.size("dp"))

    # the dp geo train step, dropout on, two steps
    cfg = inp["cfg"]
    state = train_geo.create_geo_state(cfg, device="cpu", seed=0)
    M.replicate(state.model, dp)
    step = M.make_sharded_geo_train_step(cfg, dp)
    gen = torch.Generator().manual_seed(1)
    out["geo_metrics"] = [step(state, inp["batch"], gen)]
    out["geo_stats"] = {k: v.clone() for k, v in
                        state.model.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))}
    out["geo_metrics"].append(step(state, inp["batch"], gen))
    out["geo_params"] = {k: v.clone() for k, v in
                         state.model.state_dict().items()}

    # the sharded forward: dp rows gathered, and the sp route
    model = MultiHeadModel(cfg)
    model.load_state_dict(inp["model"])
    for name, mesh in (("dp", dp), ("sp", sp)):
        fwd = M.make_sharded_geo_forward(cfg, mesh, use_sp=name == "sp")
        out[f"forward_{name}"] = fwd(model, inp["batch"])

    # the agent stage under dp: val episode and one SGD PPO update
    acfg = inp["agent_cfg"]
    agent = train_agent.create_agent_state(acfg, device="cpu", seed=1)
    rows = slice(2 * pid, 2 * pid + 2)
    geo_rows = {k: v[rows] for k, v in inp["geo_out"].items()}
    batch_rows = {k: v[rows] for k, v in inp["batch"].items()}
    _, rte, rre = train_agent.make_val_episode_fn(acfg)(agent, geo_rows,
                                                        batch_rows)
    out["val"] = (rte, rre)
    mb = {k: v[2 * pid:2 * pid + 2] for k, v in inp["mb"].items()}
    out["ppo"] = train_agent.make_ppo_update_step(acfg, dp)(agent, mb)
    out["agent_params"] = {k: v.clone() for k, v in
                           agent.agent.state_dict().items()}

    # the sp message on this rank's query and key shards, gathered
    q, k, v = inp["qkv"]
    l, s = q.shape[1] // 2, k.shape[1] // 2
    msg = sp_linear_attention_message(q[:, pid * l:(pid + 1) * l],
                                      k[:, pid * s:(pid + 1) * s],
                                      v[:, pid * s:(pid + 1) * s],
                                      sp.group("sp"))
    out["sp_message"] = M.gather_rows(msg, sp.group("sp"), pid, 2, dim=1)
    la = LinearAttention(inp["la_dim"], inp["la_heads"])
    la.load_state_dict(inp["la"])
    la.eval()
    x, y = inp["la_xy"]
    with M.use_mesh(sp):
        with torch.no_grad():
            out["sp_module"] = la(x, y)
        try:
            la(x, y)
            out["sp_grad_refused"] = False
        except NotImplementedError:
            out["sp_grad_refused"] = True
    torch.save(out, f"{io}/rank{pid}.pt")
    D.barrier("end", timeout_s=120)
    D.shutdown()
    print(f"rank {pid} OK")
""")


def _run_pair(port, io):
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(port), str(pid), str(io)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"}) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    return outs


def _run_pair_retry(io):
    # bind-then-close port discovery is racy: retry on a fresh port
    for attempt in range(3):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        outs = _run_pair(port, io)
        if attempt < 2 and any("address already in use" in err.lower()
                               for _, _, err in outs):
            continue
        return outs


def _jax_linear_attention():
    """JAX's module at LA_SHAPE with its variables, and the port's module
    with the same weights."""
    c, h = LA_SHAPE["c"], LA_SHAPE["heads"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(LA_SHAPE["b"], LA_SHAPE["l"], c)).astype(np.float32)
    y = rng.normal(size=(LA_SHAPE["b"], LA_SHAPE["s"], c)).astype(np.float32)
    jla = JaxLinearAttention(num_heads=h)
    v = jla.init({"params": jax.random.key(0)}, jnp.asarray(x),
                 jnp.asarray(y), train=False)
    want = np.asarray(jla.apply(v, jnp.asarray(x), jnp.asarray(y),
                                train=False))
    p = jax.tree_util.tree_map(np.asarray, v["params"])
    dense = lambda name: torch.from_numpy(p[name]["kernel"].T.copy())
    sd = {"q_proj.weight": dense("q_proj"), "k_proj.weight": dense("k_proj"),
          "v_proj.weight": dense("v_proj"), "merge.weight": dense("merge"),
          "mlp.0.weight": dense("mlp_0"), "mlp.3.weight": dense("mlp_1"),
          "norm1.weight": torch.from_numpy(p["norm1"]["scale"]),
          "norm1.bias": torch.from_numpy(p["norm1"]["bias"]),
          "norm2.weight": torch.from_numpy(p["norm2"]["scale"]),
          "norm2.bias": torch.from_numpy(p["norm2"]["bias"])}
    la = LinearAttention(c, h)
    la.load_state_dict(sd)
    return la, (torch.from_numpy(x), torch.from_numpy(y)), want


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Runs the two workers once; returns their results and the
    single-process references."""
    torch.set_num_threads(1)
    io = tmp_path_factory.mktemp("pair")
    cfg = micro_config(train_batch_size=B)
    batch = serve.synthetic_batch(cfg, B, "cpu", seed=3,
                                  keys=serve.TRAIN_KEYS)
    model = train_geo.create_geo_state(cfg, device="cpu", seed=0).model

    acfg = micro_config(train_batch_size=B, optimizer="SGD")
    geo_state = train_geo.create_geo_state(acfg, device="cpu", seed=0)
    geo_out = train_geo.make_geo_forward(acfg)(geo_state.model, batch)
    agent = train_agent.create_agent_state(acfg, device="cpu", seed=1)
    traj, _, _ = train_agent.make_rollout_fn(acfg)(
        agent, geo_out, batch, torch.Generator().manual_seed(2))
    buf = buffer.TrajectoryBuffer(acfg.gamma, acfg.gae_lambda)
    buf.add(traj)
    mb = {k: v[:acfg.ppo_batch_size] for k, v in buf.samples().items()}

    rng = np.random.default_rng(0)
    q = np.abs(rng.normal(size=(2, 64, 4, 8))) + 0.5
    k = np.abs(rng.normal(size=(2, 40, 4, 8))) + 0.5
    v = rng.normal(size=(2, 40, 4, 8))
    qkv = [torch.from_numpy(a.astype(np.float32)) for a in (q, k, v)]
    la, la_xy, la_want = _jax_linear_attention()
    torch.save({"cfg": cfg, "batch": batch, "model": model.state_dict(),
                "agent_cfg": acfg, "geo_out": geo_out, "mb": mb,
                "qkv": qkv, "la": la.state_dict(), "la_xy": la_xy,
                "la_dim": LA_SHAPE["c"], "la_heads": LA_SHAPE["heads"]},
               io / "inputs.pt")
    outs = _run_pair_retry(io)
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"
        assert "OK" in out
    ranks = [torch.load(io / f"rank{r}.pt", weights_only=False)
             for r in range(2)]

    # the single-process references
    state = train_geo.create_geo_state(cfg, device="cpu", seed=0)
    step = train_geo.make_geo_train_step(cfg)
    gen = torch.Generator().manual_seed(1)
    geo_metrics = [step(state, batch, gen)]
    geo_stats = {k: v.clone() for k, v in state.model.state_dict().items()}
    geo_metrics.append(step(state, batch, gen))
    _, rte, rre = train_agent.make_val_episode_fn(acfg)(agent, geo_out, batch)
    ppo = train_agent.make_ppo_update_step(acfg)(agent, mb)
    with torch.no_grad():
        forward = model.eval()(batch, with_loss=False)
    return dict(ranks=ranks, cfg=cfg, batch=batch, state=state,
                geo_metrics=geo_metrics, geo_stats=geo_stats,
                val=(rte, rre), ppo=ppo,
                agent=agent, forward=forward, qkv=qkv, la=la, la_xy=la_xy,
                la_want=la_want)


def _checksum(sd):
    return sum(float(v.double().abs().sum()) for k, v in sd.items()
               if not k.endswith(("running_mean", "running_var")))


def test_the_workers_join_one_job(pair):
    for pid, r in enumerate(pair["ranks"]):
        assert r["rank"] == pid and r["world"] == 2
        assert r["shard_range"] == list(range(5 * pid, 5 * pid + 5))
        assert r["psum"] == 3.0 and r["global_batch"] == 6
        assert r["dp_coords"] == (pid, 2)
        assert r["sp_coords"] == (pid, 2, 1)


def test_dp_geo_step_equals_the_single_process_step(pair):
    """Dropout on; the JAX package's multi-process bounds."""
    want = pair["geo_metrics"]
    want_sum = _checksum(pair["state"].model.state_dict())
    for r in pair["ranks"]:
        got = r["geo_metrics"]
        np.testing.assert_allclose(got[0]["loss"].item(),
                                   want[0]["loss"].item(), rtol=1e-6)
        np.testing.assert_allclose([m["loss"].item() for m in got],
                                   [m["loss"].item() for m in want],
                                   rtol=5e-5)
        np.testing.assert_allclose(_checksum(r["geo_params"]), want_sum,
                                   rtol=5e-5)
    a, b = (r["geo_params"] for r in pair["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)      # one program


@pytest.mark.parametrize("key", train_geo.METRIC_KEYS)
def test_dp_geo_step_metrics_are_the_global_batch_s(pair, key):
    """Losses averaged over dp, P/R/A counted over it: rtol 1e-6 at step
    0 (the single-process metrics; a P/R/A of one rank's rows misses)."""
    want = pair["geo_metrics"][0][key].item()
    for r in pair["ranks"]:
        np.testing.assert_allclose(r["geo_metrics"][0][key].item(), want,
                                   rtol=1e-6, atol=1e-7)


def test_dp_running_stats_are_the_global_batch_s(pair):
    """After the first step (the second starts from parameters that Adam
    has already moved apart by the step bound), within rtol 1e-4 and 1e-5
    of each tensor's largest entry (a running mean near 0 is a cancelling
    sum), and the same bits on both ranks."""
    want = pair["geo_stats"]
    a, b = (r["geo_stats"] for r in pair["ranks"])
    assert len(a) == 2 * sum(1 for k in want if k.endswith("running_mean"))
    for k, v in a.items():
        w = want[k].numpy()
        np.testing.assert_allclose(v.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
        assert torch.equal(v, b[k]), k


def test_per_rank_batchnorm_statistics_would_miss_the_bounds(pair):
    """The contrast: each rank's rows through the train-mode forward with
    its own statistics (a plain data-parallel wrap; dropout off on both
    sides, so only the statistics differ) give a mean loss outside the
    step-0 bound, and a mean gradient off the global batch's by far more
    than the parameter bound."""
    cfg, batch = pair["cfg"], pair["batch"]

    def loss_and_grads(rows):
        state = train_geo.create_geo_state(cfg, device="cpu", seed=0)
        set_dropout_rate(state.model, 0.0)
        state.model.train()
        out = state.model({k: v[rows] for k, v in batch.items()},
                          with_loss=True)
        out["loss"].backward()
        return out["loss"].item(), [p.grad.clone() for p in
                                    state.model.parameters()]

    whole, g_whole = loss_and_grads(slice(0, B))
    halves = [loss_and_grads(slice(2 * r, 2 * r + 2)) for r in range(2)]
    per_rank = np.mean([h[0] for h in halves])
    assert abs(per_rank - whole) > 1e-6 * abs(whole) * 100
    g_rank = [(a + b) / 2 for a, b in zip(halves[0][1], halves[1][1])]
    worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(g_rank, g_whole))
    assert worst > 5e-5 * 100


def test_dp_val_episode_and_ppo_update_match_one_process(pair):
    rte, rre = pair["val"]
    got_rte = torch.cat([r["val"][0] for r in pair["ranks"]])
    got_rre = torch.cat([r["val"][1] for r in pair["ranks"]])
    np.testing.assert_allclose(got_rte.numpy(), rte.numpy(), rtol=1e-4)
    np.testing.assert_allclose(got_rre.numpy(), rre.numpy(), rtol=1e-4,
                               atol=1e-3)
    for r in pair["ranks"]:
        for k in ("loss", "bc_loss"):
            np.testing.assert_allclose(r["ppo"][k].item(),
                                       pair["ppo"][k].item(), rtol=1e-4)
        want = pair["agent"].agent.state_dict()
        for k, v in r["agent_params"].items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=k)


def test_sp_message_equals_jax_unsharded_message(pair):
    q, k, v = (a.numpy() for a in pair["qkv"])
    want = np.asarray(jax_message(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v)))
    np.testing.assert_allclose(
        linear_attention_message(*pair["qkv"]).numpy(), want, rtol=1e-5,
        atol=1e-6)
    for r in pair["ranks"]:
        np.testing.assert_allclose(r["sp_message"].numpy(), want, rtol=1e-5,
                                   atol=1e-6)


def test_sp_linear_attention_module_equals_jax_module(pair):
    """The live module takes the sp route under a mesh with sp = 2 (and
    refuses it with gradients on); its output is JAX's unsharded one."""
    with torch.no_grad():
        np.testing.assert_allclose(pair["la"].eval()(*pair["la_xy"]).numpy(),
                                   pair["la_want"], rtol=1e-5, atol=1e-6)
    for r in pair["ranks"]:
        np.testing.assert_allclose(r["sp_module"].numpy(), pair["la_want"],
                                   rtol=1e-5, atol=1e-6)
        assert r["sp_grad_refused"]


@pytest.mark.parametrize("axis", ["dp", "sp"])
def test_sharded_geo_forward_returns_the_unsharded_outputs(pair, axis):
    want = pair["forward"]
    for r in pair["ranks"]:
        got = r[f"forward_{axis}"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].float().numpy(),
                                       want[k].float().numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


# ------------------------------------------------------ one process, no job

def test_single_process_mesh_and_helpers():
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1
    assert list(distributed.shard_range(7)) == list(range(7))
    assert distributed.psum_scalar(2.5) == 2.5
    distributed.barrier("alone")
    mesh = pmesh.make_mesh(device="cpu")
    assert mesh.shape == {"dp": 1} and mesh.rank("dp") == 0
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(pmesh.batch_sharding(mesh, 2).shard(x), x)
    assert pmesh.batch_token_sharding(mesh, 2).spec == ("dp", "sp")
    with pytest.raises(ValueError, match="over 1 processes"):
        pmesh.make_mesh((2,), device="cpu")
    with pytest.raises(ValueError, match="cluster"):
        distributed.initialize(None, 2, 0, device="cpu")


def test_sharding_takes_this_rank_s_rows():
    """The shard a rank takes along each named axis, and the refusal of
    an axis that does not split evenly."""
    mesh = pmesh.Mesh((2, 3), ("dp", "sp"), "cpu")
    mesh.rank = {"dp": 1, "sp": 2}.get
    x = torch.arange(4 * 6 * 2).reshape(4, 6, 2)
    got = pmesh.batch_token_sharding(mesh, 3).shard(x)
    assert torch.equal(got, x[2:4, 4:6])
    assert torch.equal(pmesh.batch_sharding(mesh, 3).shard(x), x[2:4])
    with pytest.raises(ValueError, match="does not split"):
        pmesh.batch_sharding(mesh, 2).shard(torch.zeros(3, 2))
    geo = pmesh.shard_geo_batch({"pc": x, "K": torch.zeros(4, 3, 3)}, mesh,
                                use_sp=True)
    assert torch.equal(geo["pc"], x[2:4, 4:6]) and geo["K"].shape == (2, 3, 3)


def test_shard_batch_puts_the_batch_on_the_device():
    batch = {"a": np.arange(6, dtype=np.float32).reshape(3, 2)}
    got = shard_batch(batch, device="cpu")
    assert torch.equal(got["a"], torch.from_numpy(batch["a"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            serve.resolve_device("cuda")
    mesh = pmesh.make_mesh(device="cpu")
    assert torch.equal(shard_batch(batch, mesh)["a"], got["a"])


def test_single_process_sharded_step_is_the_step():
    """At one process the mesh step is the plain step, bit for bit."""
    cfg = micro_config()
    batch = serve.synthetic_batch(cfg, 2, "cpu", keys=serve.TRAIN_KEYS)
    got, want = (train_geo.create_geo_state(cfg, device="cpu", seed=0)
                 for _ in range(2))
    m_got = pmesh.make_sharded_geo_train_step(
        cfg, pmesh.make_mesh(device="cpu"))(
        got, batch, torch.Generator().manual_seed(4))
    m_want = train_geo.make_geo_train_step(cfg)(
        want, batch, torch.Generator().manual_seed(4))
    assert all(torch.equal(m_got[k], m_want[k]) for k in m_want)
    for (k, a), b in zip(got.model.state_dict().items(),
                         want.model.state_dict().values()):
        assert torch.equal(a, b), k


# ----------------------------------------------------------- --debug-nans

def test_debug_nans_fails_fast_in_the_forward_and_the_backward():
    bn = BatchNorm(3).train()
    x = torch.randn(5, 3)
    x[2, 1] = float("nan")
    try:
        common.set_debug_nans(True)
        with pytest.raises(FloatingPointError, match="BatchNorm"):
            bn(x)
        bn(torch.randn(5, 3))                # finite: passes
        # log(0) * 0 is a finite forward whose backward makes 0 * inf
        w = torch.zeros(3, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (torch.log(w) * 0.0).sum().backward()
    finally:
        common.set_debug_nans(False)
    bn(x)                                    # off again: no raise
    assert not torch.is_anomaly_enabled()


def test_debug_nans_flag_turns_the_checks_on():
    p = common.add_common_args(__import__("argparse").ArgumentParser())
    args = p.parse_args(["--tiny", "--debug-nans"])
    try:
        common.build_config(args)
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
    finally:
        common.set_debug_nans(False)
    args = p.parse_args(["--tiny"])
    common.build_config(args)
    assert not torch.is_anomaly_enabled()
    assert not (args.distributed or args.coordinator)
    common.maybe_initialize_distributed(args)       # no flags: no job
    assert not torch.distributed.is_initialized()
