"""The port's serving export (``cmr_agent_tpu_torch/train/export.py``) and
its ``cmr::`` operators on the CPU.

The JAX package's geo forward and episode artifacts (``jax.export``,
loaded and called) against the port's (``torch.export``, loaded and
called) on ``tiny_config(raster_topk=1024)`` with 3 episode steps, with the
same weights through the bridge; each port artifact against the eager
body it traced, bit for bit; the ``cmr::`` nodes of each graph; an
artifact loaded and run in a process without JAX; ``.call``'s refusals;
and each operator's fake implementation against its plain version and
against the card's refusals. The composed pipeline's artifact is held in
``tests/test_torch_export_composed.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from cmr_agent_tpu.config import tiny_config as jax_tiny_config
from cmr_agent_tpu.data import SyntheticDataset, collate
from cmr_agent_tpu.models import CMRAgent as JaxAgent
from cmr_agent_tpu.models import MultiHeadModel as JaxMultiHead
from cmr_agent_tpu.train import export as jax_export
from cmr_agent_tpu_torch import serve
from cmr_agent_tpu_torch.config import tiny_config
from cmr_agent_tpu_torch.models.agent import CMRAgent
from cmr_agent_tpu_torch.models.multi_head import MultiHeadModel
from cmr_agent_tpu_torch.ops import kernels
from cmr_agent_tpu_torch.train import export
from cmr_agent_tpu_torch.train.convert import flax_to_state_dict

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4                 # tests/test_torch_geo.py
MARGIN = 1e-4               # tests/test_torch_episode.py
GEO_KEYS = ("img", "pc", "node", "pt2node", "K")
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _counted_launches(fn):
    """Calls of each forward wrapper while ``fn()`` runs on the CPU (where
    the wrappers count no launch): wrapper name -> calls, zeros left out."""
    calls = {name: 0 for name in kernels.OPERATORS}
    saved = {name: getattr(kernels, name) for name in calls}

    def counting(name, real):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return wrapper

    try:
        for name, real in saved.items():
            setattr(kernels, name, counting(name, real))
        with torch.no_grad():
            fn()
    finally:
        for name, real in saved.items():
            setattr(kernels, name, real)
    return {k: v for k, v in calls.items() if v}


@pytest.fixture(scope="module")
def served():
    """Both packages' geo forward and episode artifacts (the episode with
    ``bearing_init`` off and on) on one batch and one set of weights."""
    jcfg = jax_tiny_config(raster_topk=1024, action_num=STEPS)
    cfg = tiny_config(raster_topk=1024, action_num=STEPS)
    ds = SyntheticDataset(jcfg, length=2, seed=13)
    full = collate([ds[0], ds[1]])
    batch_np = {k: full[k] for k in GEO_KEYS}
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    geo, agent = JaxMultiHead(jcfg), JaxAgent(jcfg)
    gv = _numpy_tree(jax.jit(lambda r, b: geo.init(
        r, b, train=False, with_loss=False))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jb))
    h, w, f = jcfg.image_h, jcfg.image_w, jcfg.embed_dim
    av = _numpy_tree(jax.jit(lambda r, o2, o3: agent.init(
        {"params": r}, o2, o3, train=False))(
        jax.random.key(2), jnp.zeros((2, h, w, 2 * f)),
        jnp.zeros((2, jcfg.num_pt, 5))))
    pm = MultiHeadModel(cfg).eval()
    pm.load_state_dict(flax_to_state_dict(cfg, gv, "multihead"))
    pa = CMRAgent(cfg).eval()
    pa.load_state_dict(flax_to_state_dict(cfg, av, "agent"))

    jgeo = jax_export.load_exported(jax_export.export_geo_forward(
        jcfg, gv, jb)).call(jb)
    tb = _t(batch_np)
    geo_blob = export.export_geo_forward(cfg, pm, tb)
    geo_art = export.load_exported(geo_blob)

    # the episode's state from the JAX geo outputs; with bearing_init the
    # frustum mask stands in for the overlap prediction (a bearing away
    # from zero), as test_export.py's bearing case does
    state_np = {k: np.asarray(jgeo[k]) for k in export.EPISODE_KEYS
                if k in jgeo}
    state_np.update(pc=batch_np["pc"], K=batch_np["K"])
    bearing_np = dict(state_np, pc_overlap_pred=full["pc_mask"].astype(bool),
                      pc_is_in_cam_scores=full["pc_mask"].astype(np.float32))
    episodes = {}
    for name, bearing, st in (("identity", False, state_np),
                              ("bearing", True, bearing_np)):
        jc = jax_tiny_config(raster_topk=1024, action_num=STEPS,
                             bearing_init=bearing)
        c = tiny_config(raster_topk=1024, action_num=STEPS,
                        bearing_init=bearing)
        want = jax_export.load_exported(jax_export.export_episode(
            jc, av, {k: jnp.asarray(v) for k, v in st.items()})).call(
            {k: jnp.asarray(v) for k, v in st.items()})
        blob = export.export_episode(c, pa, _t(st))
        episodes[name] = dict(cfg=c, state=_t(st), want=np.asarray(want),
                              blob=blob, art=export.load_exported(blob))
    return dict(cfg=cfg, tb=tb, pm=pm, pa=pa, jgeo=jgeo, geo_blob=geo_blob,
                geo_art=geo_art, episodes=episodes)


@pytest.mark.parametrize("key", export.GEO_OUTPUT_KEYS)
def test_geo_forward_artifact_matches_jax_artifact(served, key):
    """Each of the six outputs of the two packages' loaded geo forward
    artifacts: floats at atol 1e-4, the overlap flags equal away from the
    0.5 threshold (tests/test_torch_geo.py)."""
    got = served["geo_art"].call(served["tb"])[key].numpy()
    want = np.asarray(served["jgeo"][key])
    assert got.shape == want.shape
    if key == "pc_overlap_pred":
        p = np.asarray(served["jgeo"]["pc_is_in_cam_scores"])
        near = np.abs(p - 0.5) < 1e-4
        np.testing.assert_array_equal(got[~near], want[~near])
    else:
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), atol=ATOL)


@pytest.mark.parametrize("case", ["identity", "bearing"])
def test_episode_artifact_matches_jax_artifact(served, case):
    """The final poses of the two packages' loaded episode artifacts at
    atol 1e-4, from the identity and, under ``bearing_init``, from the
    bearing yaw (``test_episode_export_honours_bearing_init``). Every
    action of the port's episode is clear of a near-tie (top-2 logit
    margin above 1e-4), so the actions taken are the JAX episode's."""
    ep = served["episodes"][case]
    got = ep["art"].call(ep["state"])
    np.testing.assert_allclose(got.numpy(), ep["want"], atol=1e-4)
    with torch.no_grad():
        _, steps = serve.refine_episode(ep["cfg"], served["pa"], ep["state"])
    assert len(steps) == STEPS
    for logits in (x for pair in steps for x in pair):
        top2 = torch.topk(logits, 2, dim=-1).values
        assert bool((top2[..., 0] - top2[..., 1] > MARGIN).all())
    if case == "bearing":
        eye = torch.eye(4).expand_as(got)
        assert not torch.allclose(got, eye, atol=1e-3)


def test_geo_forward_artifact_equals_its_eager_body(served):
    """The loaded artifact gives the bits of the eager body it traced."""
    got = served["geo_art"].call(served["tb"])
    with torch.no_grad():
        want = export.geo_forward_body(served["pm"])(served["tb"])
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", ["identity", "bearing"])
def test_episode_artifact_equals_its_eager_body(served, case):
    ep = served["episodes"][case]
    with torch.no_grad():
        want = export.episode_body(ep["cfg"], served["pa"])(ep["state"])
    assert torch.equal(ep["art"].call(ep["state"]), want)
    assert torch.equal(ep["art"].run(ep["state"]), want)


def test_geo_forward_graph_holds_its_kernels(served):
    """The geo forward's graph holds one ``cmr::`` node per wrapper call of
    the eager forward (its segment softmaxes, knn and gathers), and no
    node of a plain version."""
    art = served["geo_art"]
    want = _counted_launches(lambda: served["pm"](served["tb"]))
    assert want.get("segment_softmax_attend", 0) > 0 and want.get("knn", 0)
    assert export.kernel_nodes(art) == want
    assert art.meta["plain_nodes"] == 0
    assert art.meta["kind"] == "geo_forward"


@pytest.mark.parametrize("case", ["identity", "bearing"])
def test_episode_graph_holds_one_raster_per_step(served, case):
    """The episode's graph: one projection-fused raster node per step
    (``action_num``), nothing else of the kernels, no plain version."""
    art = served["episodes"][case]["art"]
    assert export.kernel_nodes(art) == {
        "segment_mean_count_image_project": STEPS}
    assert art.meta["plain_nodes"] == 0
    assert set(art.keys) == set(export.EPISODE_KEYS)


@pytest.mark.parametrize("case", ["geo", "identity", "bearing"])
def test_artifact_makes_no_tensor_from_host_data(served, case):
    """Neither artifact's graph makes a tensor from host data (the step
    tables are made by fill operations on the inputs' device): on the card
    such a node is a copy from the host at every call, which a CUDA graph
    cannot capture."""
    art = (served["geo_art"] if case == "geo"
           else served["episodes"][case]["art"])
    assert export.host_data_nodes(art) == 0


def test_host_data_nodes_counts_host_made_tensors():
    """A body that makes a tensor from a list, indexes with a tuple and
    assigns a scalar into a slice has three such nodes; its device-made
    counterpart none."""
    class Host(torch.nn.Module):
        def forward(self, x):
            y = x[..., (0, 2)] + torch.tensor([1.0, 2.0])
            y[..., 0] = 1.0
            return y

    class Device(torch.nn.Module):
        def forward(self, x):
            y = x[..., 0::2] + torch.stack(
                [torch.full((), v, device=x.device) for v in (1.0, 2.0)])
            y[..., 0].fill_(1.0)
            return y

    x = torch.randn(2, 3)
    assert export.host_data_nodes(torch.export.export(
        Host(), (x,), strict=False)) == 3
    assert export.host_data_nodes(torch.export.export(
        Device(), (x,), strict=False)) == 0


def test_plain_nodes_counts_a_bypassed_wrapper(served):
    """A wrapper swapped for its plain version traces into aten nodes the
    export counts, in place of the ``cmr::`` node (the check the card's
    phase 19 relies on)."""
    saved = kernels.knn
    kernels.knn = kernels.knn_plain
    try:
        art = export.load_exported(export.export_geo_forward(
            served["cfg"], served["pm"], served["tb"]))
    finally:
        kernels.knn = saved
    assert "knn" not in export.kernel_nodes(art)
    assert art.meta["plain_nodes"] > 0


def test_artifact_runs_in_a_process_without_jax(served, tmp_path):
    """An artifact loads and runs in a fresh process with jax, flax, orbax
    and the JAX package blocked, and gives the bits of this process."""
    ep = served["episodes"]["bearing"]
    path = tmp_path / "episode.pt2"
    path.write_bytes(ep["blob"])
    torch.save(ep["state"], tmp_path / "state.pt")
    want = ep["art"].call(ep["state"])
    torch.save(want, tmp_path / "want.pt")
    code = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "flax", "orbax", "optax", "cmr_agent_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import torch
from cmr_agent_tpu_torch.train.export import load_exported
d = sys.argv[1]
got = load_exported(d + "/episode.pt2").call(torch.load(d + "/state.pt"))
assert torch.equal(got, torch.load(d + "/want.pt"))
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "flax", "orbax", "cmr_agent_tpu")]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-1] == "ok"


def test_call_refuses_other_inputs(served):
    """``.call`` raises on a missing key, a shape or a dtype other than the
    artifact's."""
    art, state = served["episodes"]["identity"]["art"], \
        served["episodes"]["identity"]["state"]
    with pytest.raises(KeyError, match="pc_geo_feat"):
        art.call({k: v for k, v in state.items() if k != "pc_geo_feat"})
    with pytest.raises(ValueError, match="shape"):
        art.call(dict(state, pc=state["pc"][:, :-1]))
    with pytest.raises(TypeError, match="dtype"):
        art.call(dict(state, pc=state["pc"].double()))
    assert torch.equal(art.call(dict(state, extra=torch.zeros(1))),
                       art.call(state))


def test_export_leaves_the_modules_mode_alone(served):
    """The export traces in eval mode and gives each module its mode
    back."""
    pa = served["pa"]
    ep = served["episodes"]["identity"]
    pa.train()
    try:
        art = export.load_exported(export.export_episode(ep["cfg"], pa,
                                                         ep["state"]))
        assert pa.training
    finally:
        pa.eval()
    assert torch.equal(art.call(ep["state"]), ep["art"].call(ep["state"]))


# --------------------------------------------------------------------------
# the operators' fake implementations
# --------------------------------------------------------------------------

def _operator_cases():
    """One CPU call of each operator, made from numpy seeds: name ->
    arguments."""
    rng = np.random.default_rng(3)

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def ints(lo, hi, *shape):
        return torch.from_numpy(rng.integers(lo, hi, size=shape)
                                .astype(np.int32))

    pcT = torch.cat([f32(2, 2, 50), f32(2, 1, 50).abs() + 1], dim=1)
    ab = torch.tensor([[4.0, 0, 4, 0, 4, 3, 0, 0, 1, 0, 0, 0]] * 2)
    w = [f32(6, 8), f32(8, 5)]
    b = [f32(8), f32(5)]
    return {
        "segment_softmax_attend": (f32(2, 40, 6), f32(2, 40, 6),
                                   ints(-1, 9, 2, 40), 7),
        "gather_rows": (f32(2, 9, 5), ints(-1, 10, 2, 30)),
        "knn": (f32(2, 30, 3), f32(2, 12, 3), 4),
        "segment_mean_count_image_project": (
            pcT, f32(2, 50, 6), ab, torch.tensor([50, 20], dtype=torch.int32),
            6, 8, 2),
        "segment_sum": (f32(2, 40, 6), ints(-1, 9, 2, 40), 7),
        "segment_mean_count_image": (f32(2, 40, 6), ints(-1, 50, 2, 40), 6,
                                     8, 1),
        "segment_sum_shared": (f32(2, 40, 6), ints(-1, 9, 2, 3, 40), 7),
        "mask_compact_pack": (ints(0, 2, 2, 40).bool(), f32(2, 3, 40),
                              f32(2, 40, 6), 16),
        "segment_sum_count_image_compact": (f32(2, 40, 6),
                                            ints(-1, 50, 2, 40), 6, 8, 2),
        "fused_dense_chain": (f32(2, 30, 6), w, b, None, None, None, None,
                              None, [0.1, 1.0], "none", 1.0, True),
        "fused_dense_chain_cn": (f32(2, 6, 30), w, b, f32(6, 5), f32(5),
                                 None, None, None, [0.2, 0.1], "proj", 0.3,
                                 False),
        "segment_sum_image": (f32(2, 40, 6), ints(-1, 50, 2, 40), 6, 8, 0),
    }


@pytest.mark.parametrize("name", list(kernels.OPERATORS))
def test_operator_fake_matches_its_plain_version(name):
    """``torch.library.opcheck``: the schema holds and the fake
    implementation gives the outputs' shapes, dtypes and strides that the
    CPU implementation (the plain version) gives."""
    args = _operator_cases()[name]
    torch.library.opcheck(kernels.OPERATORS[name], args,
                          test_utils=("test_schema", "test_faketensor"))


REFUSALS = ("softmax_m_65536", "softmax_f16", "softmax_mixed",
            "gather_int64_ids", "knn_n_4097", "knn_k_33", "raster_f16",
            "raster_counts_f32", "segment_sum_m_0", "segment_sum_m_65536",
            "image_f16", "shared_rows_65537", "pack_k_0",
            "pack_mixed_devices", "compact_f16",
            "chain_4_layers", "chain_f64", "factored_int8", "factored_w_129")


def _card_refusals():
    """Calls the kernels refuse on CUDA tensors, on fake CUDA tensors made
    inside the fake mode: case -> (exception, call)."""
    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="cuda")

    def i(*shape):
        return t(*shape, dtype=torch.int32)

    eye = t(1, 12)
    counts = i(1)
    return {
        "softmax_m_65536": (RuntimeError, lambda: kernels.
                            segment_softmax_attend(t(1, 64, 8), t(1, 64, 8),
                                                   i(1, 64), 65536)),
        "softmax_f16": (TypeError, lambda: kernels.segment_softmax_attend(
            t(1, 64, 8, dtype=torch.float16),
            t(1, 64, 8, dtype=torch.float16), i(1, 64), 4)),
        "softmax_mixed": (TypeError, lambda: kernels.segment_softmax_attend(
            t(1, 64, 8), t(1, 64, 8, dtype=torch.bfloat16), i(1, 64), 4)),
        "gather_int64_ids": (TypeError, lambda: kernels.gather_rows(
            t(1, 9, 4), t(1, 5, dtype=torch.int64))),
        "knn_n_4097": (ValueError, lambda: kernels.knn(t(1, 4097, 3),
                                                       t(1, 8, 3), 4)),
        "knn_k_33": (ValueError, lambda: kernels.knn(t(1, 64, 3),
                                                     t(1, 8, 3), 33)),
        "raster_f16": (ValueError, lambda: kernels.
                       segment_mean_count_image_project(
                           t(1, 3, 64), t(1, 64, 8), eye, counts, 4, 4,
                           torch.float16)),
        "raster_counts_f32": (TypeError, lambda: kernels.
                              segment_mean_count_image_project(
                                  t(1, 3, 64), t(1, 64, 8), eye, t(1), 4,
                                  4)),
        "segment_sum_m_0": (ValueError, lambda: kernels.segment_sum(
            t(1, 64, 8), i(1, 64), 0)),
        "segment_sum_m_65536": (RuntimeError, lambda: kernels.segment_sum(
            t(1, 64, 8), i(1, 64), 65536)),
        "image_f16": (ValueError, lambda: kernels.segment_mean_count_image(
            t(1, 64, 8), i(1, 64), 4, 4, torch.float16)),
        "shared_rows_65537": (RuntimeError, lambda: kernels.
                              segment_sum_shared(t(1, 65537, 2),
                                                 i(1, 2, 65537), 9)),
        "pack_k_0": (ValueError, lambda: kernels.mask_compact_pack(
            t(1, 64, dtype=torch.bool), t(1, 3, 64), t(1, 64, 8), 0)),
        "pack_mixed_devices": (ValueError, lambda: kernels.mask_compact_pack(
            torch.empty(1, 64, dtype=torch.bool), t(1, 3, 64), t(1, 64, 8),
            4)),
        "compact_f16": (ValueError, lambda: kernels.
                        segment_sum_count_image_compact(
                            t(1, 64, 8), i(1, 64), 4, 4, torch.float16)),
        "chain_4_layers": (ValueError, lambda: kernels.fused_dense_chain(
            t(1, 64, 8), [t(8, 8)] * 4, [t(8)] * 4, slopes=[None] * 4)),
        "chain_f64": (TypeError, lambda: kernels.fused_dense_chain(
            t(1, 64, 8, dtype=torch.float64), [t(8, 8)], [t(8)],
            slopes=[None])),
        "factored_int8": (ValueError, lambda: kernels.segment_sum_image(
            t(1, 64, 8), i(1, 64), 4, 4, torch.int8)),
        "factored_w_129": (ValueError, lambda: kernels.segment_sum_image(
            t(1, 64, 8), i(1, 64), 2, 129)),
    }


@pytest.mark.parametrize("case", REFUSALS)
def test_fake_raises_what_the_card_refuses(case):
    """On CUDA tensors the fake implementations (what ``torch.export``
    traces) raise what the wrappers raise on the card before any launch,
    so an export fails where the eager call would."""
    with FakeTensorMode():
        cases = _card_refusals()
        assert set(cases) == set(REFUSALS)
        kind, call = cases[case]
        with pytest.raises(kind):
            call()


def _mixed_device_launches():
    """Each operator's CUDA implementation (the launch) called with one
    host tensor among CUDA ones, made inside the fake mode: name -> call."""
    def t(*shape, dtype=torch.float32, device="cuda"):
        return torch.empty(shape, dtype=dtype, device=device)

    def host_ids(*shape):
        return t(*shape, dtype=torch.int32, device="cpu")

    w, b = t(8, 8), t(8)
    return {
        "segment_softmax_attend": lambda: kernels._segment_softmax_attend_cuda(
            t(1, 64, 8), t(1, 64, 8), host_ids(1, 64), 4),
        "gather_rows": lambda: kernels._gather_rows_cuda(
            t(1, 9, 4), host_ids(1, 5)),
        "knn": lambda: kernels._knn_cuda(t(1, 64, 3), t(1, 8, 3,
                                                        device="cpu"), 4),
        "raster_project": lambda: kernels._raster_project_cuda(
            t(1, 3, 64), t(1, 64, 8), t(1, 12), host_ids(1), 4, 4, 0),
        "segment_sum": lambda: kernels._segment_sum_cuda(
            t(1, 64, 8), host_ids(1, 64), 4),
        "segment_mean_count_image": lambda: kernels.
        _segment_mean_count_image_cuda(t(1, 64, 8), host_ids(1, 64), 4, 4, 0),
        "segment_sum_shared": lambda: kernels._segment_sum_shared_cuda(
            t(1, 64, 2), host_ids(1, 2, 64), 9),
        "mask_pack": lambda: kernels._mask_pack_cuda(
            t(1, 64, dtype=torch.bool, device="cpu"), t(1, 3, 64),
            t(1, 64, 8), 4),
        "segment_sum_count_image_compact": lambda: kernels.
        _segment_sum_count_image_compact_cuda(t(1, 64, 8), host_ids(1, 64),
                                              4, 4, 0),
        "segment_sum_image": lambda: kernels._segment_sum_image_cuda(
            t(1, 64, 8), host_ids(1, 64), 4, 4, 0),
        "fused_dense_chain": lambda: kernels._fused_dense_chain_cuda(
            t(1, 64, 8), [w], [b], None, None, None,
            t(64, device="cpu"), t(1, 8), [1.0], "none", 1.0, False),
        "fused_dense_chain_cn": lambda: kernels._fused_dense_chain_cn_cuda(
            t(1, 8, 64), [w], [b], None, None, None, t(64), t(1, 8,
                                                             device="cpu"),
            [1.0], "none", 1.0, False),
    }


MIXED = ("segment_softmax_attend", "gather_rows", "knn", "raster_project",
         "segment_sum", "segment_mean_count_image", "segment_sum_shared",
         "mask_pack", "segment_sum_count_image_compact", "segment_sum_image",
         "fused_dense_chain", "fused_dense_chain_cn")


@pytest.mark.parametrize("case", MIXED)
def test_launch_refuses_mixed_devices(case):
    """Each launch refuses a host tensor among CUDA ones before it reads a
    pointer (the dispatcher sends any call that holds a CUDA tensor to
    the launch): a host pointer would otherwise reach the kernel."""
    with FakeTensorMode():
        cases = _mixed_device_launches()
        assert set(cases) == set(MIXED)
        with pytest.raises(ValueError, match="devices"):
            cases[case]()


def test_fake_gives_the_card_outputs():
    """On CUDA tensors the fake implementations give the kernels' outputs:
    kernel 1 f32 for bf16 operands, the chain's max only with ``out_max``,
    int32 neighbours."""
    with FakeTensorMode():
        x = torch.empty(2, 40, 6, dtype=torch.bfloat16, device="cuda")
        idx = torch.empty(2, 40, dtype=torch.int32, device="cuda")
        out, sums, gmax = kernels.segment_softmax_attend(x, x, idx, 7, True)
        assert out.dtype == sums.dtype == gmax.dtype == torch.float32
        assert tuple(out.shape) == (2, 7, 6) and tuple(gmax.shape) == (2, 6)
        assert out.device.type == "cuda"
        xyz = torch.empty(2, 30, 3, device="cuda")
        nn_ = kernels.knn(xyz, xyz, 4)
        assert nn_.dtype == torch.int32 and tuple(nn_.shape) == (2, 30, 4)
        means, cnt = kernels.segment_mean_count_image(
            torch.empty(2, 40, 6, device="cuda"), idx, 6, 8, torch.int8)
        assert tuple(means.shape) == (2, 48, 6) and tuple(cnt.shape) == (2, 48)
