"""Multi-process dry run of training under a dp x sp mesh (counterpart of
the JAX package's ``__graft_entry__.py``).

:func:`entry` returns the geo forward with its loss at ``kitti_config()``,
batch 1, as ``(fn, example_args)``. :func:`dryrun_multichip` starts ``n``
ranks and runs the JAX dryrun's legs, each held to the same work done in
one process:

1. one geo train step on the layouts dp x sp = (n/2, 2) and, when 4
   divides n, (n/4, 4), the ``LinearAttention`` modules on their sp route
   (``make_sharded_geo_train_step``): the loss within rtol 5e-4, the
   update's norm within rtol 5e-3, and the sp-routed modules' gradients
   (summed over sp, averaged over dp) within :data:`LA_GRAD_TOL` of the
   largest one-process entry among them once the ReLUs that took the
   other side of zero are accounted for (:func:`relu_flip_correction`);
   the same correction is shown to close the gap that a last-bit nudge of
   the cloud (:data:`NUDGE`) opens in one process;
2. on the first layout, the sharded geo forward, a dp rollout (its
   actions equal to one process's rollout of the whole batch) and one PPO
   update on a dp-divisible minibatch of it (loss rtol 5e-4);
3. the dp IterModel step on the first layout's frozen geo outputs, under
   ``cost_volume_remat`` (loss rtol 5e-4), every rank issuing the same
   all-reduces in the same order;
4. a 6-DoF rollout over dp: actions ``[..., 3]``, finite rewards, and the
   actions of one process's 6-DoF rollout.

Each rank counts its kernel launches, seconds, seconds inside all-reduces
and peak memory per leg (the one-process references, which rank 0 runs
before each leg, are not counted), and its peak over the whole run
(references included). It prints the transport, then one line in the
form of the JAX dryrun's.

Ranks use NCCL with one card a rank when the machine has ``n`` cards, else
gloo ranks sharing card 0 (gloo all-reduces CUDA tensors through the
host); ``device="cpu"`` runs gloo ranks on the CPU. With CUDA asked for and
no card it raises: it never falls back to the CPU. Run it as::

    python -m cmr_agent_tpu_torch.tools.multichip_dryrun --ranks 4 \\
        [--width kitti|tiny|micro] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[2]
WIDTHS = ("kitti", "tiny", "micro")
ITER_EXTRA_KEYS = ("R_amplitude", "T_amplitude", "label_R", "label_T_x",
                   "label_T_z")
# the sp-routed gradients against one process's, as a share of the largest
# one-process entry, once the ReLU flips are accounted for
LA_GRAD_TOL = 1e-3
NUDGE = 1.0 + 2.0 ** -23          # one process's witness: the cloud nudged


def width_config(width: str, **overrides):
    from ..config import kitti_config, micro_config, tiny_config
    return {"kitti": kitti_config, "tiny": tiny_config,
            "micro": micro_config}[width](**overrides)


def entry(device="cuda", width: str = "kitti"):
    """``(fn, example_args)``: ``fn(params, buffers, batch) -> (loss,
    pc_geo_feat, img_geo_feat)``, the eval-mode geo forward with its loss
    (JAX ``__graft_entry__.entry``) at ``width`` (KITTI by default), batch
    1, the model's weights drawn from seed 0 and the synthetic batch from
    seed 0, all on ``device`` (CUDA unless asked otherwise)."""
    import torch
    from .. import serve
    from ..models.multi_head import MultiHeadModel
    dev = serve.resolve_device(device)
    cfg = width_config(width)
    batch = serve.synthetic_batch(cfg, 1, dev, seed=0, keys=serve.TRAIN_KEYS)
    model = MultiHeadModel(cfg)
    serve.init_random_(model, torch.Generator().manual_seed(0))
    model.to(dev).eval()
    params = {k: v.detach() for k, v in model.named_parameters()}
    buffers = dict(model.named_buffers())

    def fn(params, buffers, batch):
        with torch.no_grad():
            out = torch.func.functional_call(model, {**params, **buffers},
                                             (batch,), {"with_loss": True})
        return out["loss"], out["pc_geo_feat"], out["img_geo_feat"]

    return fn, (params, buffers, batch)


def layouts_for(n: int):
    """The JAX dryrun's ``(dp, sp)`` layouts of ``n`` ranks: dp x sp=2
    (sp=1 for odd n), and (n/4, 4) when 4 divides n."""
    sp2 = 2 if n % 2 == 0 and n > 1 else 1
    out = [(n // sp2, sp2)]
    if n % 4 == 0:
        out.append((n // 4, 4))
    return out


def transport(n: int, device: str):
    """``(backend, card per rank)``: NCCL with a card a rank where the
    machine has ``n`` cards, else gloo (sharing card 0 under CUDA)."""
    import torch
    if device == "cpu":
        return "gloo", False
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA asked for but torch.cuda is not available; "
                           "pass device='cpu'")
    if torch.cuda.device_count() >= n:
        return "nccl", True
    return "gloo", False


def cards() -> str:
    """The cards' names and power limits as ``nvidia-smi`` gives them,
    joined by "; " (empty where it cannot say)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return "; ".join(x.strip() for x in out.splitlines() if x.strip())


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------------ a rank

class _Recorder:
    """Per leg: seconds, seconds inside ``torch.distributed.all_reduce``
    (the card synchronised at entry, so it holds the transfer and the wait
    for the group's last rank to arrive; the two are not told apart), the
    all-reduces' element counts in order, kernel launches and peak
    memory."""

    def __init__(self, torch, kernels, dev):
        import torch.distributed as dist
        self.torch, self.kernels, self.dev = torch, kernels, dev
        self.cuda = dev.type == "cuda"
        self.legs: Dict[str, dict] = {}
        self.calls: list = []
        self.comm_s = 0.0
        self.peak = 0.0
        inner = dist.all_reduce

        def all_reduce(tensor, *args, **kw):
            self.sync()
            t0 = time.perf_counter()
            work = inner(tensor, *args, **kw)
            self.sync()
            self.comm_s += time.perf_counter() - t0
            self.calls.append(int(tensor.numel()))
            return work

        dist.all_reduce = all_reduce

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)

    def peak_gib(self) -> Optional[float]:
        """The rank's peak memory so far, legs and references alike."""
        if not self.cuda:
            return None
        self.peak = max(self.peak, self.torch.cuda.max_memory_allocated(
            self.dev) / 2 ** 30)
        return self.peak

    def leg(self, name: str, fn):
        torch = self.torch
        self.sync()
        if self.cuda:
            self.peak_gib()
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.kernels.reset_launch_counts()
        self.calls, self.comm_s = [], 0.0
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        seconds = time.perf_counter() - t0
        self.legs[name] = {
            "seconds": seconds, "allreduce_seconds": self.comm_s,
            "allreduces": list(self.calls),
            "launches": {k: v for k, v in
                         self.kernels.launch_counts().items() if v},
            "peak_gib": (torch.cuda.max_memory_allocated(self.dev) / 2 ** 30
                         if self.cuda else None)}
        return out


def _free(torch, dev):
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _la_grads(model) -> Dict[str, "object"]:
    from ..models.linear_attention import LinearAttention
    return {f"{mn}.{pn}": p.grad.detach().clone()
            for mn, m in model.named_modules()
            if isinstance(m, LinearAttention)
            for pn, p in m.named_parameters() if p.grad is not None}


def _grad_err(got: dict, want: dict):
    """``(max|got - want| / max|want|, the tensor of that max)`` over the
    gradients together (one tensor's own largest entry is no scale: the
    LayerNorm biases whose output a later BatchNorm re-centres have
    gradients of rounding size)."""
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    diff = {k: float((got[k].double().cpu() - want[k].double()).abs().max())
            for k in want}
    worst = max(diff, key=diff.get)
    return (diff[worst] / max(float(want[k].double().abs().max())
                              for k in want), worst)


class ReluProbe:
    """Hooks on every ``LinearAttention`` of ``model``; per module name it
    keeps the sign mask ``h > 0`` of the MLP's ReLU input and, with
    ``grads``, the MLP's input ``a`` and the cotangent ``g`` of the ReLU's
    output: the gradient of ``mlp.0.weight`` is ``((h > 0) * g)^T a``
    summed over the tokens. A ReLU input that lies within rounding of zero
    takes either side in two runs that round alike inputs apart, and then
    moves that gradient by one token's whole term."""

    def __init__(self, model, grads: bool = True):
        from ..models.linear_attention import LinearAttention
        self.seen: Dict[str, dict] = {}
        self.handles = []
        for name, m in model.named_modules():
            if isinstance(m, LinearAttention):
                rec = self.seen.setdefault(name, {})
                if grads:
                    self.handles.append(m.mlp[0].register_forward_hook(
                        functools.partial(self._input, rec)))
                self.handles.append(m.mlp[1].register_forward_hook(
                    functools.partial(self._relu, rec, grads)))

    @staticmethod
    def _input(rec, module, inputs, output):
        rec["a"] = inputs[0].detach()

    @staticmethod
    def _relu(rec, grads, module, inputs, output):
        rec["mask"] = inputs[0].detach() > 0
        if grads and output.requires_grad:
            output.register_hook(lambda g: rec.__setitem__("g", g.detach()))

    def close(self) -> Dict[str, dict]:
        for h in self.handles:
            h.remove()
        return self.seen


def relu_flip_correction(seen: Dict[str, dict], ref_masks: Dict[str, "object"],
                         dp: int = 1, dp_rank: int = 0, sp_rank: int = 0):
    """``{LA name: (C, flips)}`` from a :class:`ReluProbe`'s record of this
    rank's step: ``C`` is the part of the module's ``mlp.0.weight``
    gradient (as the step reduces it: over dp the mean) that comes from
    the ReLUs whose sign differs from ``ref_masks``', ``((mask - ref_mask)
    * g / dp)^T a`` over this rank's tokens, and ``flips`` how many ReLUs
    differ, both float64 tensors. ``ref_masks`` hold the whole batch; this
    rank's block of it is its ``dp`` rows and ``sp`` tokens."""
    out = {}
    for name, r in seen.items():
        mask = r["mask"]
        n, l = mask.shape[:2]
        ref = ref_masks[name][dp_rank * n:(dp_rank + 1) * n,
                              sp_rank * l:(sp_rank + 1) * l].to(mask.device)
        diff = (mask.double() - ref.double()) * r["g"].double() / dp
        c = diff.flatten(0, -2).T @ r["a"].double().flatten(0, -2)
        out[name] = (c, (mask != ref).sum().double())
    return out


def _corrected(grads: dict, corr: dict) -> dict:
    """``grads`` with each module's ``mlp.0.weight`` less its ReLU-flip part
    ``C`` (:func:`relu_flip_correction`)."""
    out = dict(grads)
    for name, (c, _) in corr.items():
        k = f"{name}.mlp.0.weight"
        out[k] = grads[k].double() - c.to(grads[k].device)
    return out


def _update_norm(model, init: dict) -> float:
    return float(sum(((p.detach().double() - init[k].double()) ** 2).sum()
                     for k, p in model.named_parameters()) ** 0.5)


def run_rank(spec: dict, rank: int, n: int, port: int) -> dict:
    """One rank's legs (see the module docstring); returns its record,
    and rank 0's holds every rank's and the results."""
    import torch
    from .. import serve
    from ..env.buffer import TrajectoryBuffer
    from ..ops import kernels
    from ..parallel import distributed as D
    from ..parallel import mesh as M
    from ..train import train_agent, train_geo, train_iter

    dev = torch.device(spec["device"] if spec["device"] == "cpu"
                       else f"cuda:{rank if spec['card_per_rank'] else 0}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kernels.library()
    else:
        torch.set_num_threads(1)
    D.initialize(f"127.0.0.1:{port}", n, rank, device=dev.type,
                 backend=spec["backend"], local_device_ids=[dev.index or 0],
                 timeout_s=spec["timeout_s"])
    rec = _Recorder(torch, kernels, dev)
    b = spec["batch"]
    cfg = width_config(spec["width"], train_batch_size=b,
                       cost_volume_remat=True)
    batch = serve.synthetic_batch(cfg, b, dev, seed=0,
                                  keys=serve.TRAIN_KEYS + ITER_EXTRA_KEYS)
    gen = lambda seed: torch.Generator(device=dev).manual_seed(seed)
    lead = rank == 0
    results: dict = {"layouts": [], "batch": b}

    # ---- 1. the geo step on each layout, against one process's
    def one_process(scale: float, grads: bool):
        state = train_geo.create_geo_state(cfg, dev, seed=0)
        init = {k: p.detach().clone() for k, p in
                state.model.named_parameters()}
        probe = ReluProbe(state.model, grads)
        m = train_geo.make_geo_train_step(cfg)(
            state, dict(batch, pc=batch["pc"] * scale), gen(1))
        out = (m["loss"].item(), _update_norm(state.model, init),
               {k: v.cpu() for k, v in _la_grads(state.model).items()},
               probe.close())
        del state, init, m
        return out

    ref = None
    if lead:
        loss, norm, la_grads, seen = one_process(1.0, False)
        masks = {k: r["mask"].cpu() for k, r in seen.items()}
        # the witness in one process: a last-bit nudge of the cloud
        _, _, nudged, seen = one_process(NUDGE, True)
        corr = relu_flip_correction(seen, masks)
        raw, raw_at = _grad_err(nudged, la_grads)
        fixed, fixed_at = _grad_err(_corrected(nudged, corr), la_grads)
        ref = {"loss": loss, "norm": norm, "la_grads": la_grads,
               "masks": masks, "nudge": dict(
                   la_grad_rel_err=fixed, worst=fixed_at,
                   la_grad_rel_err_raw=raw, worst_raw=raw_at,
                   relu_flips=int(sum(f for _, f in corr.values())))}
        del seen, corr, nudged
        _free(torch, dev)
    ref = D.broadcast_object(ref)
    assert np.isfinite(ref["loss"]), f"non-finite one-process loss {ref}"
    results["nudge"] = ref["nudge"]
    meshes, geo_state = [], None
    for dp, sp in spec["layouts"]:
        mesh = M.make_mesh((dp, sp), ("dp", "sp"), device=dev)
        meshes.append(mesh)
        state = train_geo.create_geo_state(cfg, dev, seed=0)
        M.replicate(state.model, mesh)
        init = {k: p.detach().clone() for k, p in
                state.model.named_parameters()}
        step = M.make_sharded_geo_train_step(cfg, mesh)
        probe = ReluProbe(state.model)
        m = rec.leg(f"geo_step_dp{dp}_sp{sp}",
                    lambda: step(state, batch, gen(1)))
        corr = relu_flip_correction(probe.close(), ref["masks"], dp,
                                    mesh.rank("dp"), mesh.rank("sp"))
        # summed over every rank's block
        M.all_reduce_flat([t for pair in corr.values() for t in pair], None)
        loss, norm = m["loss"].item(), _update_norm(state.model, init)
        la_grads = _la_grads(state.model)
        raw, raw_at = _grad_err(la_grads, ref["la_grads"])
        la_err, la_at = _grad_err(_corrected(la_grads, corr),
                                  ref["la_grads"])
        np.testing.assert_allclose(loss, ref["loss"], rtol=5e-4, err_msg=(
            f"dp={dp} sp={sp} loss diverged from one process"))
        np.testing.assert_allclose(norm, ref["norm"], rtol=5e-3, err_msg=(
            f"dp={dp} sp={sp} update norm diverged from one process"))
        assert la_err <= LA_GRAD_TOL, (
            f"dp={dp} sp={sp}: the sp-routed LinearAttention gradients are "
            f"{la_err:.3e} of the largest entry off one process's at "
            f"{la_at} once the ReLU flips are accounted for ({raw:.3e} "
            f"before, at {raw_at})")
        results["layouts"].append(dict(
            dp=dp, sp=sp, loss=loss, loss_ref=ref["loss"], norm=norm,
            norm_ref=ref["norm"], la_grad_rel_err=la_err, worst=la_at,
            la_grad_rel_err_raw=raw, worst_raw=raw_at,
            relu_flips=int(sum(f for _, f in corr.values()))))
        del init, corr, la_grads
        if geo_state is None:
            geo_state = state
        del state
        _free(torch, dev)

    # ---- 2. the rollout and one PPO update under dp, on the first layout
    mesh = meshes[0]
    dp = mesh.size("dp")
    dp_group = (mesh.group("dp"), mesh.rank("dp"), dp)
    per = b // dp
    rows = slice(mesh.rank("dp") * per, (mesh.rank("dp") + 1) * per)
    local = lambda d: {k: v[rows] for k, v in d.items()}
    gather = lambda d: (d if dp == 1 else
                        {k: M.gather_rows(v, *dp_group, dim=1)
                         for k, v in d.items()})
    fwd = M.make_sharded_geo_forward(cfg, mesh)
    geo_out = rec.leg("geo_forward", lambda: fwd(geo_state.model, batch))
    del geo_state
    _free(torch, dev)

    def rollout_leg(c, seed_agent, seed_gen, leg):
        ref_actions = None
        if lead:
            a = train_agent.create_agent_state(c, dev, seed=seed_agent)
            t, _, _ = train_agent.make_rollout_fn(c)(a, geo_out, batch,
                                                     gen(seed_gen))
            ref_actions = {k: t[k].cpu() for k in ("action_r", "action_t")}
            del a, t
        ref_actions = D.broadcast_object(ref_actions)
        agent = train_agent.create_agent_state(c, dev, seed=seed_agent)
        M.replicate(agent.agent, mesh)
        roll = train_agent.make_rollout_fn(c, mesh=mesh)
        traj, _, _ = rec.leg(leg, lambda: roll(agent, local(geo_out),
                                               local(batch), gen(seed_gen)))
        traj = gather(traj)
        same = all(torch.equal(traj[k].cpu(), ref_actions[k])
                   for k in ref_actions)
        assert same, f"{leg}: the dp rollout's actions are not one process's"
        return traj, same

    traj, same = rollout_leg(cfg, 2, 3, "rollout")
    buf = TrajectoryBuffer(cfg.gamma, cfg.gae_lambda)
    buf.add(traj)
    nrows = max(dp, cfg.ppo_batch_size // dp * dp)
    mb = {k: v[:nrows] for k, v in buf.samples().items()}
    ppo_ref = None
    if lead:
        a = train_agent.create_agent_state(cfg, dev, seed=2)
        ppo_ref = train_agent.make_ppo_update_step(cfg)(a, mb)["loss"].item()
        del a
    ppo_ref = D.broadcast_object(ppo_ref)
    agent = train_agent.create_agent_state(cfg, dev, seed=2)
    M.replicate(agent.agent, mesh)
    upd = train_agent.make_ppo_update_step(cfg, mesh)
    mper = nrows // dp
    mb_local = {k: v[mesh.rank("dp") * mper:(mesh.rank("dp") + 1) * mper]
                for k, v in mb.items()}
    agent_loss = rec.leg("ppo_update",
                         lambda: upd(agent, mb_local))["loss"].item()
    np.testing.assert_allclose(agent_loss, ppo_ref, rtol=5e-4,
                               err_msg="dp PPO loss diverged from one "
                                       "process")
    results["agent"] = dict(loss=agent_loss, loss_ref=ppo_ref,
                            rows=nrows, actions_equal=same)
    del agent, traj, buf, mb, mb_local
    _free(torch, dev)

    # ---- 3. the IterModel step under dp on the frozen geo outputs
    ist = train_iter.iter_model_state(geo_out, batch)
    iter_ref = None
    if lead:
        it = train_iter.create_iter_state(cfg, dev, seed=6,
                                          steps_per_epoch=10)
        iter_ref = train_iter.make_iter_train_step(cfg)(
            it, ist)["cost_volume_loss"].item()
        del it
        _free(torch, dev)
    iter_ref = D.broadcast_object(iter_ref)
    assert np.isfinite(iter_ref), f"non-finite one-process iter loss"
    it = train_iter.create_iter_state(cfg, dev, seed=6, steps_per_epoch=10)
    M.replicate(it.model, mesh)
    istep = train_iter.make_iter_train_step(cfg, mesh=mesh)
    iter_loss = rec.leg("iter_step", lambda: istep(it, local(ist)))[
        "cost_volume_loss"].item()
    np.testing.assert_allclose(iter_loss, iter_ref, rtol=5e-4,
                               err_msg="dp IterModel loss diverged from "
                                       "one process")
    results["iter"] = dict(loss=iter_loss, loss_ref=iter_ref)
    del it, ist
    _free(torch, dev)

    # ---- 4. the 6-DoF rollout over dp
    cfg6 = width_config(spec["width"], train_batch_size=b, is_6_dof=True)
    traj6, same6 = rollout_leg(cfg6, 4, 5, "rollout_6dof")
    assert traj6["action_r"].shape[-1] == 3 \
        and traj6["action_t"].shape[-1] == 3, (
        f"6-DoF rollout action shapes {tuple(traj6['action_r'].shape)} / "
        f"{tuple(traj6['action_t'].shape)}")
    assert bool(torch.isfinite(traj6["reward"]).all()), "6-DoF rewards"
    results["six_dof"] = dict(actions_equal=same6,
                              action_shape=list(traj6["action_r"].shape))

    record = {"rank": rank, "device": str(dev),
              "device_name": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"),
              "legs": rec.legs,
              "peak_gib": rec.peak_gib()}
    ranks = D.gather_objects(record)
    if lead:
        for leg in ranks[0]["legs"]:
            seqs = {tuple(r["legs"][leg]["allreduces"]) for r in ranks}
            assert len(seqs) == 1, (
                f"{leg}: the ranks issued different all-reduces")
        results["ranks"] = ranks
        results["line"] = summary_line(results)
    D.barrier("done", timeout_s=spec["timeout_s"])
    D.shutdown()
    return results if lead else record


def summary_line(res: dict) -> str:
    """The JAX dryrun's result line (``__graft_entry__.py:304-308``)."""
    lay = ", ".join(
        f"dp={r['dp']} sp={r['sp']} loss={r['loss']:.4f} "
        f"(ref {r['loss_ref']:.4f}) upd-norm={r['norm']:.4e} "
        f"(ref {r['norm_ref']:.4e})" for r in res["layouts"])
    return (f"dryrun_multichip OK [equality-asserted]: {lay}; "
            f"agent loss={res['agent']['loss']:.4f} == single-device "
            f"{res['agent']['loss_ref']:.4f}; "
            f"iter loss={res['iter']['loss']:.4f} == single-device "
            f"{res['iter']['loss_ref']:.4f}; 6-DoF rollout OK")


# ------------------------------------------------------------- the launcher

def _wait(procs, logs, timeout_s: float):
    """Wait for every rank; once one fails or time runs out, stop the
    others. Returns the exit codes."""
    t_end = time.monotonic() + timeout_s
    while True:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            return codes
        if any(c not in (None, 0) for c in codes) \
                or time.monotonic() > t_end:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            return [p.returncode for p in procs]
        time.sleep(0.2)


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     width: str = "kitti", timeout_s: float = 900.0,
                     out_dir: Optional[str] = None) -> dict:
    """Start ``n_devices`` ranks and run the dry run's legs (module
    docstring) at ``width`` on a global batch of ``max(2, n_devices)``
    rows, as the JAX dryrun's. Prints the transport and the result line;
    returns rank 0's results (every rank's record under ``"ranks"``).
    Raises if a rank fails, with its log's tail; ranks and logs live in
    ``out_dir`` (a fresh temporary directory by default)."""
    if width not in WIDTHS:
        raise ValueError(f"width {width!r} not in {WIDTHS}")
    backend, card_per_rank = transport(n_devices, device)
    if device != "cpu":
        from ..ops import kernels
        kernels.library()           # one build, before the ranks load it
    layouts = layouts_for(n_devices)
    b = max(2, n_devices)
    out = Path(out_dir or tempfile.mkdtemp(prefix="multichip_dryrun_"))
    out.mkdir(parents=True, exist_ok=True)
    spec = dict(device=device, width=width, batch=b, layouts=layouts,
                backend=backend, card_per_rank=card_per_rank,
                timeout_s=timeout_s)
    (out / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    where = ("one card a rank" if card_per_rank else
             "the CPU" if device == "cpu" else
             f"card 0 shared by {n_devices} ranks")
    smi = "" if device == "cpu" else cards()
    print(f"[multichip_dryrun] ranks={n_devices} backend={backend} "
          f"devices={where} width={width} batch={b} layouts={layouts}"
          + (f" nvidia_smi={smi!r}" if smi else ""), flush=True)
    for attempt in range(3):
        port = free_port()
        logs = [out / f"rank{r}.log" for r in range(n_devices)]
        procs = []
        for r in range(n_devices):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", __spec__.name if __spec__ else
                     "cmr_agent_tpu_torch.tools.multichip_dryrun",
                     "--worker", str(r), str(n_devices), str(port),
                     str(out)], cwd=REPO, env=env, stdout=f,
                    stderr=subprocess.STDOUT))
        codes = _wait(procs, logs, timeout_s)
        tails = [p.read_text()[-4000:] for p in logs]
        if all(c == 0 for c in codes):
            break
        if attempt < 2 and any("address already in use" in t.lower()
                               for t in tails):
            continue
        bad = [r for r, c in enumerate(codes) if c != 0]
        raise RuntimeError(f"multichip dryrun: ranks {bad} exited "
                           f"{[codes[r] for r in bad]}\n"
                           + "\n".join(f"--- rank {r}\n{tails[r]}"
                                       for r in bad))
    res = json.loads((out / "result.json").read_text())
    res["nvidia_smi"] = smi
    (out / "result.json").write_text(json.dumps(res))
    print(res["line"], flush=True)
    return res


def _worker(argv) -> int:
    rank, n, port, out = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    spec = json.loads(Path(out, "spec.json").read_text())
    res = run_rank(spec, rank, n, port)
    if rank == 0:
        Path(out, "result.json").write_text(json.dumps(res))
    return 0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--width", choices=WIDTHS, default="kitti")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out-dir", default=None)
    opts = ap.parse_args(argv)
    return dryrun_multichip(opts.ranks, opts.device, opts.width,
                            opts.timeout, opts.out_dir)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        sys.exit(_worker(sys.argv[2:]))
    main()
