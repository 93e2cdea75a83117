"""The fused eval stacks of the port (``fused_stacks``) against the JAX
package's (``CMR_FUSED_STACKS``), on the CPU.

Kernels 9 and 10: the port's plain versions (the wrappers take them for CPU
tensors) against ``fused_dense_chain`` / ``fused_dense_chain_cn`` in Pallas
``interpret=True`` mode. The fused modules and the whole fused slice: the
port's modules in eval mode, built with fusion on, against the JAX modules
with the fused branch forced by ``CMR_FUSED_STACK_INTERPRET=1`` (set before
the first trace: a traced function keeps the branch it traced), on the same
weights through the bridge, BatchNorm statistics made non-trivial so that
the fold is seen. Inputs come from numpy with fixed seeds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cmr_agent_tpu.config import micro_config as jax_micro_config
from cmr_agent_tpu.data import SyntheticDataset, collate
from cmr_agent_tpu.env import init_poses as jax_init_poses
from cmr_agent_tpu.env import run_episode as jax_run_episode
from cmr_agent_tpu.models import CMRAgent as JaxAgent
from cmr_agent_tpu.models import MultiHeadModel as JaxMultiHead
from cmr_agent_tpu.models.agent import (_ResDenseConcatBlock,
                                         _ResDenseSplitBlock)
from cmr_agent_tpu.models.layers import MiniPointNet as JaxMiniPointNet
from cmr_agent_tpu.models.layers import ResDenseBlock as JaxResDenseBlock
from cmr_agent_tpu.ops import pallas_kernels as pk
from cmr_agent_tpu_torch import serve
from cmr_agent_tpu_torch.config import micro_config
from cmr_agent_tpu_torch.models import layers
from cmr_agent_tpu_torch.models.agent import (CMRAgent,
                                              _fused_virtual_concat_block)
from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
from cmr_agent_tpu_torch.ops import kernels
from cmr_agent_tpu_torch.train.convert import (_MapBuilder, _flatten,
                                               _invert_transform,
                                               flax_to_state_dict)

FORCE = "CMR_FUSED_STACK_INTERPRET"
BF16_ULP = 2.0 ** -8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# --------------------------------------------------------------------------
# kernels 9 and 10: plain versions vs the Pallas kernels
# --------------------------------------------------------------------------

# (input width, layer widths, slopes, final slope, pooled width, out_max)
CHAINS = {
    "none": (8, (16, 24, 12), (0.2, None, 0.1), None, 0, True),
    "identity": (16, (24, 16), (0.2, None), 0.2, 0, False),
    "proj": (8, (16, 12), (0.2, None), 0.2, 0, False),
    "identity_split": (8, (16, 24), (0.2, None), 0.2, 16, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", list(CHAINS))
@pytest.mark.parametrize("layout", ["nc", "cn"])
def test_dense_chain_plain_matches_jax(layout, residual, dtype):
    """Every residual kind, ``[C]`` and per-batch ``[B,C]`` biases,
    ``out_max``, N = 300 (not a multiple of the 128-point tile). f32 within
    1e-5 (the sums' order differs); bf16 within one bf16 rounding of the
    output's scale (a sum that differs in its last f32 bit can round to the
    neighbouring bf16 value and carry into the next layer). The Pallas
    kernel cannot trace ``out_max`` in bf16 (its bf16 max block is assigned
    an f32 value, pallas_kernels.py:1024, 1240; ROADMAP C), so bf16 with
    ``out_max`` is held against the kernel's pure-jnp mirror, which rounds
    the same way."""
    c0, widths, slopes, final, p, out_max = CHAINS[residual]
    rng = np.random.default_rng(abs(hash((layout, residual))) % 2**32)
    b, n = 2, 300
    dims = (c0,) + widths
    ws = [rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32)
          / np.sqrt(dims[i]) for i in range(len(widths))]
    # the first layer's bias per sample, the others per channel
    bs = [rng.normal(size=(b, widths[0])).astype(np.float32)] + [
        rng.normal(size=(w,)).astype(np.float32) for w in widths[1:]]
    rw = rb = pooled = None
    if residual == "proj":
        rw = (rng.normal(size=(c0, widths[-1])) / np.sqrt(c0)).astype(
            np.float32)
        rb = rng.normal(size=(b, widths[-1])).astype(np.float32)
    if residual == "identity_split":
        pooled = rng.normal(size=(b, p)).astype(np.float32)
    x = rng.normal(size=(b, n, c0)).astype(np.float32)
    if layout == "cn":
        x = np.ascontiguousarray(x.transpose(0, 2, 1))
    jopt = lambda a: None if a is None else jnp.asarray(a)   # noqa: E731
    jargs = (jnp.asarray(x, jnp.dtype(dtype)),
             tuple(jnp.asarray(w) for w in ws),
             tuple(jnp.asarray(v) for v in bs), jopt(rw), jopt(rb),
             jopt(pooled))
    jkw = dict(slopes=slopes, residual=residual, final_slope=final,
               out_max=out_max)
    if dtype == "bfloat16" and out_max:
        jfn = (pk._dense_chain_cn_reference if layout == "cn"
               else pk._dense_chain_reference)
        want = jfn(*jargs, **jkw)
    else:
        jfn = (pk.fused_dense_chain_cn if layout == "cn"
               else pk.fused_dense_chain)
        want = jfn(*jargs, **jkw, tile=128, interpret=True)
    tfn = (kernels.fused_dense_chain_cn if layout == "cn"
           else kernels.fused_dense_chain)
    topt = lambda a: None if a is None else _t(a)            # noqa: E731
    got = tfn(_t(x).to(getattr(torch, dtype)), [_t(w) for w in ws],
              [_t(v) for v in bs], topt(rw), topt(rb), topt(pooled),
              slopes=slopes, residual=residual, final_slope=final,
              out_max=out_max)
    if not out_max:
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        assert tuple(g.shape) == tuple(w.shape)
        g, w = _np(g), _np(w)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(
                g, w, rtol=BF16_ULP, atol=BF16_ULP * np.abs(w).max())


# --------------------------------------------------------------------------
# the fused modules: port vs JAX, same weights
# --------------------------------------------------------------------------

def _random_variables(init, seed):
    """Variables with the tree of ``init()`` (traced for shapes only, which
    is far cheaper than running it) drawn from ``seed``: kernels at fan-in
    scale, and BatchNorm scale, bias and running statistics at random too
    (an initialised BN folds to the identity)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


def _load(module, variables, register):
    """Load a JAX module's variables into a port module through the
    bridge's name maps (``register(builder, torch_prefix)``)."""
    b = _MapBuilder()
    register(b, "m")
    flat = {c: _flatten(variables.get(c, {})) for c in ("params",
                                                         "batch_stats")}
    sd = {tk[2:]: torch.from_numpy(_invert_transform(
        tag, np.asarray(flat[coll][fp.lstrip("/")], np.float32)).copy())
        for tk, coll, fp, tag in b.entries}
    module.load_state_dict(sd)
    return module.eval()


# (JAX module, its inputs' channels, port module, bridge entries, kind)
def _module_cases():
    return {
        "minipointnet": (JaxMiniPointNet(16), 3,
                         layers.MiniPointNet(3, 16, fused=True),
                         lambda b, p: b.mini_pointnet(p, ""), "stack"),
        "res_proj": (JaxResDenseBlock(16), 8,
                     layers.ResDenseBlock(8, 16, fused=True),
                     lambda b, p: b.res_dense(p, "", True), "stack"),
        "res_identity": (JaxResDenseBlock(16), 16,
                         layers.ResDenseBlock(16, 16, fused=True),
                         lambda b, p: b.res_dense(p, "", False), "stack"),
        "split": (_ResDenseSplitBlock(16), 16,
                  layers.ResDenseBlock(32, 16, fused=True),
                  lambda b, p: b.res_dense(p, "", True), "virtual"),
        "concat": (_ResDenseConcatBlock(32), 16,
                   layers.ResDenseBlock(32, 32, fused=True),
                   lambda b, p: b.res_dense(p, "", False), "virtual"),
    }


@pytest.mark.parametrize("case,cn", [
    ("minipointnet", False), ("res_proj", False), ("res_proj", True),
    ("res_identity", False), ("res_identity", True), ("split", False),
    ("split", True), ("concat", False), ("concat", True)])
def test_fused_modules_match_jax(case, cn, monkeypatch):
    """The port's fused eval modules (``MiniPointNet``, ``ResDenseBlock``,
    the agent's split / concat blocks over the virtual concat) against the
    JAX modules' fused branch, row-major and channel-major (the agent's
    blocks and ``ResDenseBlock``; ``MiniPointNet`` is row-major only): f32
    within 1e-5. Row-major, also against the port's unfused module on the
    same weights: BN folding changes only the rounding, 1e-5."""
    jmod, c, port, register, kind = _module_cases()[case]
    rng = np.random.default_rng(7)
    b, n = 2, 130
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    pooled = rng.normal(size=(b, 16)).astype(np.float32)
    xin = x.transpose(0, 2, 1) if cn else x
    monkeypatch.setenv(FORCE, "1")
    if kind == "virtual":
        jmod = jmod.clone(cn=cn)
        pin = pooled[:, :, None] if cn else pooled[:, None, :]
        args = (jnp.asarray(xin), jnp.asarray(pin))
    else:
        if cn:
            jmod = jmod.clone(cn=True)
        args = (jnp.asarray(xin),)
    v = _random_variables(lambda: jmod.init(jax.random.key(3), *args, False),
                          seed=11)
    want = np.asarray(jmod.apply(v, *args, False))
    port = _load(port, v, register)
    with torch.no_grad():
        tx = _t(np.ascontiguousarray(xin))
        if kind == "virtual":
            got = _fused_virtual_concat_block(port, tx, _t(pooled), cn)
        elif cn:
            got = port(tx, cn=True)
        else:
            got = port(tx)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        if cn:
            return
        port.fused = False
        full = (_t(np.concatenate([x, np.broadcast_to(
            pooled[:, None, :], (b, n, 16))], -1))
            if kind == "virtual" else tx)
        unfused = port(full)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_fused_module_trains_unfused():
    """``train()`` mode never takes the fused branch (batch statistics do
    not fold): the fused-built module equals the unfused one bit for bit
    and updates its running statistics."""
    torch.manual_seed(0)
    x = torch.randn(2, 64, 8)
    fused = layers.ResDenseBlock(8, 16, fused=True).train()
    plain = layers.ResDenseBlock(8, 16).train()
    plain.load_state_dict(fused.state_dict())
    calls = []
    orig = kernels.fused_dense_chain
    kernels.fused_dense_chain = lambda *a, **k: calls.append(1) or orig(*a,
                                                                        **k)
    try:
        got = fused(x)
    finally:
        kernels.fused_dense_chain = orig
    assert not calls
    assert torch.equal(got, plain(x))
    assert torch.equal(fused.net[1].running_mean, plain.net[1].running_mean)
    assert not torch.equal(fused.net[1].running_mean, torch.zeros(8))


# --------------------------------------------------------------------------
# the whole slice: fused geo forward + the cn eval episode
# --------------------------------------------------------------------------

KEYS = ("img", "pc", "node", "pt2node", "K", "P")


def _jax_episode(agent, av, state, pose_src, jcfg):
    """JAX ``run_episode`` as an eval episode (no trajectory), its
    per-step logits recorded by a host callback."""
    steps = []

    def apply(v, o2, o3):
        r, t, val = agent.apply(v, o2, o3, train=False)
        jax.debug.callback(
            lambda a, b: steps.append((np.asarray(a), np.asarray(b))), r, t,
            ordered=True)
        return r, t, val
    final, _ = jax_run_episode(apply, av, state, pose_src, None, jcfg,
                               deterministic=True,
                               raster_topk=jcfg.episode_raster_topk())
    jax.effects_barrier()
    return np.asarray(final), steps


@pytest.fixture(scope="module")
def fused_slice():
    mp = pytest.MonkeyPatch()
    mp.setenv(FORCE, "1")
    try:
        jcfg = jax_micro_config(raster_topk=256)
        cfg = micro_config(raster_topk=256, fused_stacks="all")
        ds = SyntheticDataset(jcfg, length=2, seed=5)
        batch_np = {k: v for k, v in collate([ds[0], ds[1]]).items()
                    if k in KEYS}
        jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
        model, agent = JaxMultiHead(jcfg), JaxAgent(jcfg)
        gv = _random_variables(lambda: model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jb,
            train=False, with_loss=False), seed=21)
        h, w, f = jcfg.image_h, jcfg.image_w, jcfg.embed_dim
        av = _random_variables(lambda: agent.init(
            {"params": jax.random.key(2)}, jnp.zeros((2, h, w, 2 * f)),
            jnp.zeros((2, jcfg.num_pt, 5)), train=False), seed=22)
        out = model.apply(gv, jb, train=False, with_loss=False)
        state = {"pc": out["pc"], "K": jb["K"],
                 "pc_overlap_pred": out["pc_overlap_pred"],
                 "pc_geo_feat": out["pc_geo_feat"],
                 "img_geo_feat": out["img_geo_feat"]}
        pose_src, _ = jax_init_poses(dict(state, P=jb["P"]))
        want_final, want_steps = _jax_episode(agent, av, state, pose_src,
                                              jcfg)
    finally:
        mp.undo()
    pm, pa = MultiHeadModel(cfg).eval(), CMRAgent(cfg).eval()
    pm.load_state_dict(flax_to_state_dict(cfg, gv, "multihead"))
    pa.load_state_dict(flax_to_state_dict(cfg, av, "agent"))
    tb = {k: _t(batch_np[k]) for k in serve.BATCH_KEYS}
    chains = {}
    mp = pytest.MonkeyPatch()
    for name in ("fused_dense_chain", "fused_dense_chain_cn"):
        def counted(*a, _fn=getattr(kernels, name), _name=name, **k):
            chains[_name] = chains.get(_name, 0) + 1
            return _fn(*a, **k)
        mp.setattr(kernels, name, counted)
    try:
        with torch.no_grad():
            geo = pm(tb)
        got = serve.serve_episode(pm, pa, cfg, tb)
    finally:
        mp.undo()
    return dict(cfg=cfg, out=out, geo=geo, got=got, chains=chains,
                want_final=want_final, want_steps=want_steps)


def test_fused_geo_forward_matches_jax(fused_slice):
    """The fused geo forward (7 row-major chains per forward at micro
    depth: 4 MiniPointNet, 1 node_fuse, 2 point_fuse) against the JAX
    package's fused forward: features and logits within 1e-4 (f32, several
    dozen layers deep)."""
    got, want = fused_slice["geo"], fused_slice["out"]
    for key in ("pc_geo_feat", "img_geo_feat", "pc_overlap_logits",
                "img_overlap_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-4, err_msg=key)
    np.testing.assert_array_equal(got["pc_overlap_pred"].numpy(),
                                  np.asarray(want["pc_overlap_pred"]))


def test_fused_episode_matches_jax_per_step(fused_slice):
    """The cn eval episode with the fused agent (4 channel-major chains
    per step) against JAX ``run_episode`` in its cn layout: per-step
    logits within 1e-4 and the final poses within 1e-4 (f32)."""
    cfg, got = fused_slice["cfg"], fused_slice["got"]
    assert fused_slice["chains"] == {
        "fused_dense_chain": 2 * 7,      # the forward above + the episode's
        "fused_dense_chain_cn": 4 * cfg.action_num}
    want_steps = fused_slice["want_steps"]
    assert len(got["steps"]) == len(want_steps) == cfg.action_num
    for (gr, gt), (wr, wt) in zip(got["steps"], want_steps):
        np.testing.assert_allclose(gr.numpy(), wr, atol=1e-4)
        np.testing.assert_allclose(gt.numpy(), wt, atol=1e-4)
    np.testing.assert_allclose(got["final_pose"].numpy(),
                               fused_slice["want_final"], atol=1e-4)
