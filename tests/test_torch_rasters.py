"""The port's uncompacted eval rasters (``raster_mode`` "flat", "topk",
"compact") against the JAX package's, on the CPU.

Kernel 8 (``segment_sum_count_image_compact``) and the int8 mode of kernel
6a (``segment_mean_count_image``): the port's plain versions (the wrappers
take them for CPU tensors) against the Pallas kernels in ``interpret=True``
mode. The episodes: the port's f32 eval episode under each mode against JAX
``run_episode``, whose raster takes its XLA path on the CPU. Inputs come
from numpy with fixed seeds.
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
from cmr_agent_tpu.ops import pallas_kernels as pk
from cmr_agent_tpu_torch import serve
from cmr_agent_tpu_torch.config import micro_config
from cmr_agent_tpu_torch.models.agent import CMRAgent
from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
from cmr_agent_tpu_torch.ops import kernels
from cmr_agent_tpu_torch.train.convert import flax_to_state_dict

H, W = 8, 16


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _raster_inputs(seed: int, scale: float = 1.0):
    """An unordered cloud of 1300 rows (not a multiple of the 512-row
    tile), F=8, about a third routed out both ways (id < 0, id >= h*w),
    one all-routed-out tile."""
    rng = np.random.default_rng(seed)
    b, n, f, hw = 2, 1300, 8, H * W
    data = (scale * rng.normal(size=(b, n, f))).astype(np.float32)
    ids = rng.integers(-hw // 4, hw + hw // 3, size=(b, n)).astype(np.int32)
    ids[1, 512:1024] = hw + 7
    return data, ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compact_raster_plain_matches_jax(dtype):
    """Sums within rtol 1e-5 (both round the rows to ``dtype`` once and sum
    in f32, in other orders); counts exact."""
    data, ids = _raster_inputs(0)
    jdt = None if dtype == "float32" else jnp.bfloat16
    want_s, want_c = pk.segment_sum_count_image_compact(
        jnp.asarray(data), jnp.asarray(ids), H, W, tile=512,
        compute_dtype=jdt, interpret=True)
    tdt = None if dtype == "float32" else torch.bfloat16
    got_s, got_c = kernels.segment_sum_count_image_compact(
        _t(data), _t(ids), H, W, tdt)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)
    assert got_c.sum() == ((ids >= 0) & (ids < H * W)).sum()


def _jax_flat_int8(data, ids):
    return pk.segment_mean_count_image_fused(
        jnp.asarray(data), jnp.asarray(ids), H, W, tile=512, factored=False,
        compute_dtype=jnp.int8, interpret=True)


def test_image_raster_int8_plain_matches_jax():
    """Kernel 6a in int8 (the bf16 eval episodes' "flat" and "topk"
    raster): per-(sample, channel) absmax over all rows, exact int32 sums.
    Counts exact, means within 1e-5."""
    data, ids = _raster_inputs(1)
    want_m, want_c = _jax_flat_int8(data, ids)
    got_m, got_c = kernels.segment_mean_count_image(_t(data), _t(ids), H, W,
                                                    torch.int8)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-5,
                               atol=1e-5)


def test_compact_raster_int8_equals_the_flat_int8_raster():
    """The port's compact raster quantises in int8 as the flat raster
    does, so its mean is the JAX flat int8 raster's: counts exact, means
    within 1e-5."""
    data, ids = _raster_inputs(2)
    want_m, want_c = _jax_flat_int8(data, ids)
    sums, cnt = kernels.segment_sum_count_image_compact(_t(data), _t(ids), H,
                                                        W, torch.int8)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_c))
    means = sums / cnt.clamp_min(1.0)[..., None]
    np.testing.assert_allclose(means.numpy(), np.asarray(want_m), rtol=1e-5,
                               atol=1e-5)


def test_jax_compact_int8_truncates_instead_of_quantising():
    """The JAX package's compact kernel in int8 casts the rows to int8
    without quantising (pallas_kernels.py:829-830; ROADMAP C): its sums are
    the sums of ``trunc(x)``, so every |x| < 1 contributes 0. The port does
    not copy this."""
    data, ids = _raster_inputs(3, scale=0.7)
    sums, _ = pk.segment_sum_count_image_compact(
        jnp.asarray(data), jnp.asarray(ids), H, W, tile=512,
        compute_dtype=jnp.int8, interpret=True)
    hw = H * W
    want = np.zeros((2, hw + 1, data.shape[-1]), np.float32)
    routed = np.where((ids >= 0) & (ids < hw), ids, hw)
    for b in range(2):
        np.add.at(want[b], routed[b], np.trunc(data[b]))
    np.testing.assert_array_equal(np.asarray(sums), want[:, :hw])
    port, _ = kernels.segment_sum_count_image_compact(_t(data), _t(ids), H,
                                                      W, torch.int8)
    assert np.abs(port.numpy() - np.asarray(sums)).max() > 1.0


# --------------------------------------------------------------------------
# episodes: the port vs JAX run_episode under each uncompacted-path mode
# --------------------------------------------------------------------------

KEYS = ("img", "pc", "node", "pt2node", "K", "P")


def _random_variables(init, seed):
    """Variables with the tree of ``init()`` (traced for shapes only)
    drawn from ``seed``: kernels at fan-in scale, BatchNorm statistics and
    the other leaves at random."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == "kernel":
            return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
                    ).astype(np.float32)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


@pytest.fixture(scope="module")
def geo():
    jcfg = jax_micro_config()
    ds = SyntheticDataset(jcfg, length=2, seed=9)
    batch_np = {k: v for k, v in collate([ds[0], ds[1]]).items()
                if k in KEYS}
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    model, agent = JaxMultiHead(jcfg), JaxAgent(jcfg)
    gv = _random_variables(lambda: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jb,
        train=False, with_loss=False), seed=31)
    h, w, f = jcfg.image_h, jcfg.image_w, jcfg.embed_dim
    av = _random_variables(lambda: agent.init(
        {"params": jax.random.key(2)}, jnp.zeros((2, h, w, 2 * f)),
        jnp.zeros((2, jcfg.num_pt, 5)), train=False), seed=32)
    out = model.apply(gv, jb, train=False, with_loss=False)
    state = {"pc": out["pc"], "K": jb["K"],
             "pc_overlap_pred": out["pc_overlap_pred"],
             "pc_geo_feat": out["pc_geo_feat"],
             "img_geo_feat": out["img_geo_feat"]}
    pose_src, _ = jax_init_poses(dict(state, P=jb["P"]))
    return dict(agent=agent, gv=gv, av=av, state=state, pose_src=pose_src,
                batch=batch_np)


@pytest.mark.parametrize("mode", ["flat", "topk", "compact"])
def test_uncompacted_mode_episode_matches_jax(geo, mode, monkeypatch):
    """The f32 eval episode under ``raster_mode`` ``mode`` (no compaction
    under "flat" and "compact"; the ranked top-256 of 512 rows under
    "topk"): per-step logits and the final poses within 1e-4 of JAX
    ``run_episode`` on the same weights, with one raster of the expected
    kernel per step."""
    jcfg = jax_micro_config(raster_mode=mode, raster_topk=256)
    cfg = micro_config(raster_mode=mode, raster_topk=256)
    assert cfg.episode_raster_topk() == jcfg.episode_raster_topk() == (
        256 if mode == "topk" else None)
    steps = []
    agent = geo["agent"]

    def apply(v, o2, o3):
        r, t, val = agent.apply(v, o2, o3, train=False)
        jax.debug.callback(
            lambda a, b: steps.append((np.asarray(a), np.asarray(b))), r, t,
            ordered=True)
        return r, t, val
    want_final, _ = jax_run_episode(apply, geo["av"], geo["state"],
                                    geo["pose_src"], None, jcfg,
                                    deterministic=True,
                                    raster_topk=jcfg.episode_raster_topk())
    jax.effects_barrier()

    pm, pa = MultiHeadModel(cfg).eval(), CMRAgent(cfg).eval()
    pm.load_state_dict(flax_to_state_dict(cfg, geo["gv"], "multihead"))
    pa.load_state_dict(flax_to_state_dict(cfg, geo["av"], "agent"))
    seen = {"compact": 0, "image": 0}
    for key, name in (("compact", "segment_sum_count_image_compact"),
                      ("image", "segment_mean_count_image")):
        def counted(*a, _fn=getattr(kernels, name), _key=key, **k):
            seen[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(kernels, name, counted)
    tb = {k: _t(geo["batch"][k]) for k in serve.BATCH_KEYS}
    got = serve.serve_episode(pm, pa, cfg, tb)
    n = cfg.action_num
    assert seen == {"compact": n if mode == "compact" else 0,
                    "image": 0 if mode == "compact" else n}
    assert len(got["steps"]) == len(steps) == n
    for (gr, gt), (wr, wt) in zip(got["steps"], steps):
        np.testing.assert_allclose(gr.numpy(), wr, atol=1e-4)
        np.testing.assert_allclose(gt.numpy(), wt, atol=1e-4)
    np.testing.assert_allclose(got["final_pose"].numpy(),
                               np.asarray(want_final), atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
