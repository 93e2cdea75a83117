"""Training under a dp x sp mesh on four ranks, on the CPU: the port's
counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``.

A module fixture runs four ``python -c`` workers over gloo on 127.0.0.1
(a fresh port, retried on a clash, as ``tests/test_torch_parallel.py``
does), JAX and the JAX package blocked in them, torch at one thread. They
write what they computed to ``.pt`` files, which this process holds
against one process's results and JAX's. What they show, at
``micro_config``:

* the geo train step on the layouts dp x sp = (2, 2) and (1, 4), the
  ``LinearAttention`` modules on their sp route, dropout on, is one
  process's step on the 4 rows: the step-0 loss within rtol 1e-5 and the
  parameter checksum after two steps within rtol 5e-5;
* the sp route's gradients (the module's own, summed over sp and averaged
  over dp by ``reduce_gradients``, and its inputs') are JAX's: ``jax.grad``
  through ``LinearAttention`` under ``set_mesh`` of a (1, 2) mesh on the
  virtual CPU devices, and through the unsharded module, at dropout rate
  0, within rtol 1e-4 and atol 1e-6 of each tensor's largest entry;
* a dp rollout draws one process's actions (3-DoF, with DAgger's
  ``expert_beta`` draws, and 6-DoF with actions ``[..., 3]`` and finite
  rewards); before the draws were made at the global shape the ranks drew
  other actions;
* the dp IterModel step, with and without ``cost_volume_remat``, is one
  process's (loss, running stats, parameters), every rank issuing the same
  all-reduces in the same order, the remat step one more (the
  recomputed BatchNorm's);
* the dp PPO update is one process's;
* ``tools.multichip_dryrun.dryrun_multichip(4, device="cpu")`` runs its
  legs to their line, and ``entry`` returns the geo forward with its loss.
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
from cmr_agent_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cmr_agent_tpu_torch import serve
from cmr_agent_tpu_torch.config import micro_config
from cmr_agent_tpu_torch.env import buffer
from cmr_agent_tpu_torch.models.linear_attention import LinearAttention
from cmr_agent_tpu_torch.parallel import mesh as pmesh
from cmr_agent_tpu_torch.tools import multichip_dryrun
from cmr_agent_tpu_torch.train import train_agent, train_geo, train_iter

REPO = Path(__file__).resolve().parents[1]
B = 4                                   # global batch
LAYOUTS = {"2x2": (2, 2), "1x4": (1, 4)}
LA = dict(b=4, l=64, s=40, c=32, heads=4)
KEYS = serve.TRAIN_KEYS + multichip_dryrun.ITER_EXTRA_KEYS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the suite runs a test process per core or
    so)."""
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
    import torch.distributed as dist
    torch.set_num_threads(1)
    port, pid, io = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    inp = torch.load(f"{io}/inputs.pt", weights_only=False)

    from cmr_agent_tpu_torch.parallel import distributed as D, mesh as M
    from cmr_agent_tpu_torch.models.layers import set_dropout_rate
    from cmr_agent_tpu_torch.models.linear_attention import LinearAttention
    from cmr_agent_tpu_torch.train import train_agent, train_geo, train_iter
    D.initialize(f"127.0.0.1:{port}", 4, pid, device="cpu", timeout_s=240)
    meshes = {name: M.make_mesh(shape, ("dp", "sp"), device="cpu")
              for name, shape in inp["layouts"].items()}
    out = {}
    gen = lambda seed: torch.Generator().manual_seed(seed)
    cfg = inp["cfg"]
    B = cfg.train_batch_size
    checksum = lambda sd: sum(float(v.double().abs().sum())
                              for k, v in sd.items() if not
                              k.endswith(("running_mean", "running_var")))

    # the geo step, dropout on, two steps
    for name, mesh in meshes.items():
        state = train_geo.create_geo_state(cfg, device="cpu", seed=0)
        M.replicate(state.model, mesh)
        step = M.make_sharded_geo_train_step(cfg, mesh)
        g = gen(1)
        losses = [step(state, inp["batch"], g)["loss"].item()
                  for _ in range(2)]
        out[f"geo_{name}"] = (losses, checksum(state.model.state_dict()))

    # the sp route's gradients at dropout rate 0
    x, y, w = inp["la_xyw"]
    for name, mesh in meshes.items():
        dp = mesh.size("dp")
        rows = slice(mesh.rank("dp") * B // dp, (mesh.rank("dp") + 1) * B // dp)
        la = LinearAttention(inp["la_dim"], inp["la_heads"])
        la.load_state_dict(inp["la"])
        la.train()
        set_dropout_rate(la, 0.0)
        xr, yr = (t[rows].clone().requires_grad_() for t in (x, y))
        with M.use_mesh(mesh):
            o = la(xr, yr)
        ((o * w[rows]).sum() / (B // dp)).backward()
        M.reduce_gradients(la, mesh)
        out[f"la_{name}"] = dict(
            out=o.detach(), rows=rows, dp=dp, x=xr.grad, y=yr.grad,
            params={k: p.grad.clone() for k, p in la.named_parameters()})

    # the dp rollouts, the PPO update and the IterModel step on (2, 2)
    mesh = meshes["2x2"]
    dp_rank = mesh.rank("dp")
    rows = slice(dp_rank * 2, dp_rank * 2 + 2)
    local = lambda d: {k: v[rows] for k, v in d.items()}
    for name, c, seeds, beta in inp["rollouts"]:
        agent = train_agent.create_agent_state(c, device="cpu",
                                               seed=seeds[0])
        traj, _, _ = train_agent.make_rollout_fn(c, mesh=mesh)(
            agent, local(inp["geo_out"]), local(inp["batch"]), gen(seeds[1]),
            expert_beta=beta)
        out[f"rollout_{name}"] = {k: traj[k] for k in
                                  ("action_r", "action_t", "reward")}

    sgd = inp["sgd_cfg"]
    agent = train_agent.create_agent_state(sgd, device="cpu", seed=2)
    mb = {k: v[dp_rank * 2:dp_rank * 2 + 2] for k, v in inp["mb"].items()}
    out["ppo"] = (train_agent.make_ppo_update_step(sgd, mesh)(agent, mb),
                  {k: v.clone() for k, v in agent.agent.state_dict().items()})

    inner = dist.all_reduce
    calls = []

    def recording(tensor, *args, **kw):
        calls.append(int(tensor.numel()))
        return inner(tensor, *args, **kw)

    dist.all_reduce = recording
    for remat, c in inp["iter_cfgs"].items():
        it = train_iter.create_iter_state(c, device="cpu", seed=6,
                                          steps_per_epoch=10)
        calls.clear()
        m = train_iter.make_iter_train_step(c, mesh=mesh)(
            it, local(inp["ist"]))
        out[f"iter_{remat}"] = (m, {k: v.clone() for k, v in
                                    it.model.state_dict().items()},
                                list(calls))
    dist.all_reduce = inner

    torch.save(out, f"{io}/rank{pid}.pt")
    D.barrier("end", timeout_s=240)
    D.shutdown()
    print(f"rank {pid} OK")
""")


def _run_ranks(port, io):
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(port), str(pid), str(io)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1"}) for pid in range(4)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    return outs


def _run_ranks_retry(io):
    # bind-then-close port discovery is racy: retry on a fresh port
    for attempt in range(3):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        outs = _run_ranks(port, io)
        if attempt < 2 and any("address already in use" in err.lower()
                               for _, _, err in outs):
            continue
        return outs


def _linear_attention():
    """JAX's module's variables at LA's shape, the port's module with the
    same weights, and seeded ``x, y, w``."""
    c, h = LA["c"], LA["heads"]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(LA["b"], LA["l"], c)).astype(np.float32)
    y = rng.normal(size=(LA["b"], LA["s"], c)).astype(np.float32)
    w = rng.normal(size=(LA["b"], LA["l"], c)).astype(np.float32)
    v = JaxLinearAttention(num_heads=h).init(
        {"params": jax.random.key(0)}, jnp.asarray(x), jnp.asarray(y),
        train=False)
    p = jax.tree_util.tree_map(np.asarray, v["params"])
    la = LinearAttention(c, h)
    la.load_state_dict(
        {f"{port}.weight": torch.from_numpy(p[name]["kernel"].T.copy())
         for port, name in _DENSE.items()}
        | {f"{n}.{k}": torch.from_numpy(p[n][j].copy())
           for n in ("norm1", "norm2")
           for k, j in (("weight", "scale"), ("bias", "bias"))})
    return la, v["params"], [torch.from_numpy(a) for a in (x, y, w)]


_DENSE = {"q_proj": "q_proj", "k_proj": "k_proj", "v_proj": "v_proj",
          "merge": "merge", "mlp.0": "mlp_0", "mlp.3": "mlp_1"}


def _jax_la_grads(params, x, y, w, sp: bool):
    """``jax.grad`` of ``sum(out * w) / B`` through JAX's module (eval
    mode: no dropout) with respect to the parameters, ``x`` and ``y``;
    with ``sp`` under ``set_mesh`` of a (1, 2) dp x sp mesh, where the
    module takes the psum-decomposed sp route."""
    jla = JaxLinearAttention(num_heads=LA["heads"])

    def loss(params, x, y):
        out = jla.apply({"params": params}, x, y, train=False)
        return jnp.sum(out * w) / x.shape[0]

    grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
    args = (params, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    if not sp:
        g = grad(*args)
    else:
        mesh = jax_make_mesh((1, 2), ("dp", "sp"), devices=jax.devices()[:2])
        with jax.sharding.set_mesh(mesh):
            g = grad(*args)
    gp, gx, gy = jax.tree_util.tree_map(np.asarray, g)
    port = {f"{k}.weight": gp[n]["kernel"].T for k, n in _DENSE.items()}
    port.update({f"{n}.{k}": gp[n][j] for n in ("norm1", "norm2")
                 for k, j in (("weight", "scale"), ("bias", "bias"))})
    return port, gx, gy


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Runs the four workers once; returns their results and the
    one-process references."""
    torch.set_num_threads(1)
    io = tmp_path_factory.mktemp("multichip")
    cfg = micro_config(train_batch_size=B)
    cfg6 = micro_config(train_batch_size=B, is_6_dof=True)
    batch = serve.synthetic_batch(cfg, B, "cpu", seed=3, keys=KEYS)
    geo = train_geo.create_geo_state(cfg, device="cpu", seed=0).model
    geo_out = train_geo.make_geo_forward(cfg)(geo, batch)
    rollouts = [("3dof", cfg, (2, 3), None), ("3dof_beta", cfg, (2, 7), 0.5),
                ("6dof", cfg6, (4, 5), None)]
    want_rollouts = {}
    for name, c, seeds, beta in rollouts:
        agent = train_agent.create_agent_state(c, device="cpu", seed=seeds[0])
        traj, _, _ = train_agent.make_rollout_fn(c)(
            agent, geo_out, batch, torch.Generator().manual_seed(seeds[1]),
            expert_beta=beta)
        want_rollouts[name] = traj
    buf = buffer.TrajectoryBuffer(cfg.gamma, cfg.gae_lambda)
    buf.add(want_rollouts["3dof"])
    mb = {k: v[:4] for k, v in buf.samples().items()}
    ist = train_iter.iter_model_state(geo_out, batch)
    # SGD where parameters are compared: Adam scales the noise-level
    # gradients of the biases that a BatchNorm re-centres to full steps
    sgd = micro_config(train_batch_size=B, optimizer="SGD")
    iter_cfgs = {remat: micro_config(train_batch_size=B, optimizer="SGD",
                                     cost_volume_remat=remat)
                 for remat in (False, True)}
    la, la_params, la_xyw = _linear_attention()
    torch.save({"cfg": cfg, "batch": batch, "layouts": LAYOUTS,
                "la": la.state_dict(), "la_xyw": la_xyw,
                "la_dim": LA["c"], "la_heads": LA["heads"],
                "geo_out": geo_out, "rollouts": rollouts, "mb": mb,
                "sgd_cfg": sgd,
                "ist": ist, "iter_cfgs": iter_cfgs}, io / "inputs.pt")
    outs = _run_ranks_retry(io)
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"
        assert "OK" in out
    got = [torch.load(io / f"rank{r}.pt", weights_only=False)
           for r in range(4)]

    # the one-process references
    state = train_geo.create_geo_state(cfg, device="cpu", seed=0)
    step, gen = train_geo.make_geo_train_step(cfg), torch.Generator()
    gen.manual_seed(1)
    geo_losses = [step(state, batch, gen)["loss"].item() for _ in range(2)]
    agent = train_agent.create_agent_state(sgd, device="cpu", seed=2)
    ppo = train_agent.make_ppo_update_step(sgd)(agent, mb)
    iters = {}
    for remat, c in iter_cfgs.items():
        it = train_iter.create_iter_state(c, device="cpu", seed=6,
                                          steps_per_epoch=10)
        iters[remat] = (train_iter.make_iter_train_step(c)(it, ist),
                        it.model.state_dict())
    return dict(ranks=got, geo_losses=geo_losses,
                geo_checksum=_checksum(state.model.state_dict()),
                rollouts=want_rollouts, ppo=(ppo, agent.agent.state_dict()),
                iters=iters, la_params=la_params, la_xyw=la_xyw)


def _checksum(sd):
    return sum(float(v.double().abs().sum()) for k, v in sd.items()
               if not k.endswith(("running_mean", "running_var")))


@pytest.mark.parametrize("key", ["geo_2x2", "geo_1x4"])
def test_dp_sp_geo_step_is_one_process_s(ranks, key):
    """Dropout on (the masks drawn at the global shape, inside the sp
    route too): the step-0 loss within rtol 1e-5, both losses within rtol
    5e-5 and the parameter checksum after two steps within rtol 5e-5;
    every rank holds the same bits."""
    for r in ranks["ranks"]:
        losses, checksum = r[key]
        np.testing.assert_allclose(losses[0], ranks["geo_losses"][0],
                                   rtol=1e-5)
        np.testing.assert_allclose(losses, ranks["geo_losses"], rtol=5e-5)
        np.testing.assert_allclose(checksum, ranks["geo_checksum"],
                                   rtol=5e-5)
    assert len({r[key][1] for r in ranks["ranks"]}) == 1


@pytest.fixture(scope="module")
def jax_la_grads(ranks):
    x, y, w = ranks["la_xyw"]
    return {sp: _jax_la_grads(ranks["la_params"], x, y, w.numpy(), sp)
            for sp in (False, True)}


def _close(got, want, err_msg=""):
    """rtol 1e-4, atol 1e-6 of ``want``'s largest entry: the gradients
    reach ~12 here, where a bare atol 1e-6 lies under f32 summation noise
    (JAX's own sp route and unsharded module differ by up to 5.3e-6)."""
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max(),
                               err_msg=err_msg)


def test_jax_sp_route_gradients_are_its_unsharded_ones(jax_la_grads):
    """The reference itself: JAX's sp-route gradients against its
    unsharded module's (:func:`_close`)."""
    (gp, gx, gy), (sp_gp, sp_gx, sp_gy) = jax_la_grads[False], \
        jax_la_grads[True]
    for k in gp:
        _close(sp_gp[k], gp[k], k)
    _close(sp_gx, gx)
    _close(sp_gy, gy)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("jax_sp", [True, False])
def test_sp_route_gradients_are_jax_s(ranks, jax_la_grads, layout, jax_sp):
    """The port's sp route under (2, 2) and (1, 4): the module's own
    gradients after ``reduce_gradients`` (summed over sp, averaged over
    dp) and each rank's input gradients (its dp rows, scaled by dp from
    its rows' mean loss to the global mean's) against JAX's, with and
    without JAX's sp route (:func:`_close`)."""
    gp, gx, gy = jax_la_grads[jax_sp]
    for r in ranks["ranks"]:
        got = r[f"la_{layout}"]
        for k, v in got["params"].items():
            _close(v.numpy(), gp[k], k)
        rows, dp = got["rows"], got["dp"]
        _close(got["x"].numpy() / dp, gx[rows])
        _close(got["y"].numpy() / dp, gy[rows])


@pytest.mark.parametrize("name", ["3dof", "3dof_beta", "6dof"])
def test_dp_rollout_draws_one_process_s_actions(ranks, name):
    """(2, 2): the dp ranks' rows of the rollout (ranks 0, 1 hold rows
    0-1, ranks 2, 3 rows 2-3) take one process's actions, the DAgger
    draws included; the rewards within rtol 1e-5."""
    want = ranks["rollouts"][name]
    got = [r[f"rollout_{name}"] for r in ranks["ranks"]]
    for k in ("action_r", "action_t"):
        assert torch.equal(got[0][k], got[1][k])
        assert torch.equal(torch.cat([got[0][k], got[2][k]], dim=1),
                           want[k]), k
    np.testing.assert_allclose(
        torch.cat([got[0]["reward"], got[2]["reward"]], dim=1).numpy(),
        want["reward"].numpy(), rtol=1e-5, atol=1e-6)


def test_six_dof_dp_rollout_takes_three_plus_three_actions(ranks):
    for r in ranks["ranks"]:
        traj = r["rollout_6dof"]
        assert traj["action_r"].shape[-1] == 3
        assert traj["action_t"].shape[-1] == 3
        assert torch.isfinite(traj["reward"]).all()


def test_dp_ppo_update_is_one_process_s(ranks):
    """(2, 2), SGD: the losses within rtol 1e-5, the parameters within
    rtol 2e-4 atol 2e-5 (``tests/test_torch_parallel.py``'s SGD bounds)."""
    want_m, want_sd = ranks["ppo"]
    for r in ranks["ranks"]:
        m, sd = r["ppo"]
        for k in want_m:
            np.testing.assert_allclose(m[k].item(), want_m[k].item(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        for k, v in sd.items():
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("remat", [False, True])
def test_dp_iter_step_is_one_process_s(ranks, remat):
    """(2, 2), SGD: the metrics within rtol 1e-5, the running stats
    within rtol 1e-4 and 1e-5 of each tensor's largest entry, the
    parameters within rtol 2e-4 atol 2e-5; every rank holds the same
    bits."""
    want_m, want_sd = ranks["iters"][remat]
    for r in ranks["ranks"]:
        m, sd, _ = r[f"iter_{remat}"]
        for k in want_m:
            np.testing.assert_allclose(m[k].item(), want_m[k].item(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        for k, v in sd.items():
            w = want_sd[k].numpy()
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), w, rtol=1e-4,
                                           atol=1e-5 * np.abs(w).max(),
                                           err_msg=k)
            else:
                np.testing.assert_allclose(v.numpy(), w, rtol=2e-4,
                                           atol=2e-5, err_msg=k)
    sds = [r[f"iter_{remat}"][1] for r in ranks["ranks"]]
    assert all(torch.equal(sds[0][k], s[k]) for s in sds[1:] for k in s)


def test_remat_step_issues_the_same_all_reduces_on_every_rank(ranks):
    """The recomputed segments of a remat step run inside the backward,
    under the mesh: every rank issues the same all-reduces (by size) in
    the same order, and the remat step exactly one more than the plain
    step, the recomputed first-stage BatchNorm's sums."""
    plain = [r["iter_False"][2] for r in ranks["ranks"]]
    remat = [r["iter_True"][2] for r in ranks["ranks"]]
    assert all(c == plain[0] for c in plain)
    assert all(c == remat[0] for c in remat)
    assert len(remat[0]) == len(plain[0]) + 1
    extra = list(remat[0])
    for n in plain[0]:
        extra.remove(n)
    # sums and sums of squares of the stage's embed_dim channels, a count
    assert extra == [2 * micro_config().embed_dim + 1]


def test_dryrun_multichip_runs_to_its_line(tmp_path, capsys):
    """The dry run's four ranks at micro width on the CPU: every leg's
    equality assert holds, and it prints the transport and the JAX
    dryrun's line."""
    res = multichip_dryrun.dryrun_multichip(4, device="cpu", width="micro",
                                            out_dir=str(tmp_path),
                                            timeout_s=240)
    out = capsys.readouterr().out
    assert "backend=gloo devices=the CPU" in out
    assert "dryrun_multichip OK [equality-asserted]: dp=2 sp=2" in out
    assert "dp=1 sp=4" in out and "6-DoF rollout OK" in out
    assert [(r["dp"], r["sp"]) for r in res["layouts"]] == [(2, 2), (1, 4)]
    assert res["agent"]["actions_equal"] and res["six_dof"]["actions_equal"]
    assert res["six_dof"]["action_shape"][-1] == 3
    # the dry run's gate is LA_GRAD_TOL (1e-3) once the ReLU flips are
    # accounted for; on the CPU the raw error is 2.3e-6
    for r in res["layouts"] + [res["nudge"]]:
        assert r["la_grad_rel_err"] <= r["la_grad_rel_err_raw"] <= 1e-5
    assert len(res["ranks"]) == 4
    assert set(res["ranks"][0]["legs"]) == {
        "geo_step_dp2_sp2", "geo_step_dp1_sp4", "geo_forward", "rollout",
        "ppo_update", "iter_step", "rollout_6dof"}


def test_relu_flip_correction_is_the_flipped_relus_part():
    """``relu_flip_correction`` on a probed one-process geo step at micro
    width: against an empty reference mask it is each ``LinearAttention``'s
    whole ``mlp.0.weight`` gradient (every open ReLU counted as flipped),
    against the step's own masks zero. On a hand-made rank record it takes
    the rank's block of the reference (its dp rows, its sp tokens) and
    scales a flipped ReLU's term by 1/dp."""
    cfg = micro_config(train_batch_size=2)
    batch = serve.synthetic_batch(cfg, 2, "cpu", seed=3, keys=serve.TRAIN_KEYS)
    state = train_geo.create_geo_state(cfg, device="cpu", seed=0)
    probe = multichip_dryrun.ReluProbe(state.model)
    train_geo.make_geo_train_step(cfg)(state, batch,
                                       torch.Generator().manual_seed(1))
    seen = probe.close()
    grads = multichip_dryrun._la_grads(state.model)
    assert seen and all(set(r) == {"a", "mask", "g"} for r in seen.values())
    empty = {k: torch.zeros_like(r["mask"]) for k, r in seen.items()}
    whole = multichip_dryrun.relu_flip_correction(seen, empty)
    for name, (c, flips) in whole.items():
        g = grads[f"{name}.mlp.0.weight"].double()
        np.testing.assert_allclose(c.numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(g.abs().max()))
        assert flips == int(seen[name]["mask"].sum()) > 0
    own = {k: r["mask"] for k, r in seen.items()}
    for c, flips in multichip_dryrun.relu_flip_correction(seen, own).values():
        assert flips == 0 and not c.any()

    gen = torch.Generator().manual_seed(0)
    ref = torch.rand(2, 4, 3, generator=gen) > 0.5
    mask = ref[1:2, 2:4].clone()
    mask[0, 1, 2] = ~mask[0, 1, 2]
    g, a = torch.randn(1, 2, 3, generator=gen), torch.randn(1, 2, 5,
                                                             generator=gen)
    (c, flips), = multichip_dryrun.relu_flip_correction(
        {"la": dict(mask=mask, g=g, a=a)}, {"la": ref}, dp=2, dp_rank=1,
        sp_rank=1).values()
    want = torch.zeros(3, 5, dtype=torch.float64)
    want[2] = (1 if mask[0, 1, 2] else -1) * g[0, 1, 2].double() \
        * a[0, 1].double() / 2
    assert flips == 1
    torch.testing.assert_close(c, want)


def test_entry_is_the_geo_forward_with_its_loss():
    """``entry`` at micro width on the CPU: ``fn(*example_args)`` is the
    eval forward's loss and geo features of the batch-1 batch."""
    fn, args = multichip_dryrun.entry(device="cpu", width="micro")
    params, buffers, batch = args
    loss, pc_feat, img_feat = fn(*args)
    cfg = micro_config()
    assert pc_feat.shape[:2] == (1, cfg.num_pt) and img_feat.shape[0] == 1
    assert torch.isfinite(loss) and loss.ndim == 0
    model = train_geo.create_geo_state(cfg, device="cpu", seed=0).model
    want = train_geo.make_geo_forward(cfg, with_loss=True)(model, batch)
    assert torch.equal(loss, want["loss"])
    assert torch.equal(pc_feat, want["pc_geo_feat"])


def test_mesh_helpers_alone(monkeypatch):
    """Outside a mesh ``rand_shard`` is ``torch.rand``; the layouts are the
    JAX dryrun's; the captured multi-step refuses a mesh; with no card the
    dry run refuses CUDA rather than fall back to the CPU."""
    a = pmesh.rand_shard((3, 4), torch.Generator().manual_seed(9))
    assert torch.equal(a, torch.rand((3, 4),
                                     generator=torch.Generator().manual_seed(9)))
    mesh = pmesh.Mesh((2, 2), ("dp", "sp"), "cpu")
    assert multichip_dryrun.layouts_for(4) == [(2, 2), (1, 4)]
    assert multichip_dryrun.layouts_for(8) == [(4, 2), (2, 4)]
    assert multichip_dryrun.layouts_for(3) == [(3, 1)]
    with pytest.raises(ValueError, match="one process"):
        train_geo.make_geo_multi_step(micro_config(), 2, mesh=mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        multichip_dryrun.transport(4, "cuda")
