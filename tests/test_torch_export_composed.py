"""The port's composed coarse-to-fine artifact (``train/export.py:
export_composed_pipeline``) on the CPU: at K = 2 hypotheses, one verified
refine round over a 2-member beam, in the beam's own and in a shared
frame, on ``micro_config`` with the flagship's observation settings and 2
episode steps. Loaded and called, it gives the bits of
``serve.composed_pipeline`` (which ``tests/test_torch_compose.py`` holds
to the JAX package's exported pipeline), and its graph holds the eager
request's kernel calls as ``cmr::`` nodes, the cost volume's warp (kernel
7) among them.
"""

import pytest
import torch

from cmr_agent_tpu_torch import serve
from cmr_agent_tpu_torch.config import micro_config
from cmr_agent_tpu_torch.ops import kernels
from cmr_agent_tpu_torch.train import export

FLAGSHIP = dict(cost_volume_unmasked=True, pose_aware_observation=True,
                obs_bearing_channels=True, policy_aux_state=True,
                bearing_init=True)
OPTIONS = dict(hypotheses=2, iter_iters=2, iter_shrink=0.25,
               hypo_score="combo", refine_rounds=1,
               refine_beam=("combo", "mean_valid:2"))
FRAMES = {"own": dict(beam_score="above50_norm", beam_frame="own"),
          "shared": dict(beam_score="smooth_mean", beam_frame="shared")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _calls(fn):
    """Calls of each forward wrapper while ``fn()`` runs: name -> count."""
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
        fn()
    finally:
        for name, real in saved.items():
            setattr(kernels, name, real)
    return {k: v for k, v in calls.items() if v}


@pytest.fixture(scope="module", params=list(FRAMES))
def composed(request):
    cfg = micro_config(action_num=2, **FLAGSHIP)
    opts = dict(OPTIONS, **FRAMES[request.param])
    batch, modules, pipeline = serve.build_composed_workload(
        cfg, 2, device="cpu", seed=3, **opts)
    art = export.load_exported(export.export_composed_pipeline(
        cfg, *modules, batch, **opts))
    return dict(cfg=cfg, batch=batch, pipeline=pipeline, art=art)


def test_composed_artifact_equals_the_pipeline(composed):
    """``pose``, ``score`` and ``candidate_scores`` bit-equal to
    ``serve.composed_pipeline`` on the same batch, through ``.call`` and
    ``.run``; the pose a rigid motion."""
    want = composed["pipeline"](composed["batch"])
    for got in (composed["art"].call(composed["batch"]),
                composed["art"].run(composed["batch"])):
        assert got.keys() == want.keys() == {"pose", "score",
                                             "candidate_scores"}
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert want["candidate_scores"].shape == (2, OPTIONS["hypotheses"])
    R = want["pose"][:, :3, :3]
    torch.testing.assert_close(R @ R.transpose(1, 2),
                               torch.eye(3).expand(2, 3, 3), rtol=0,
                               atol=1e-4)


def test_composed_graph_holds_the_request_kernels(composed):
    """One ``cmr::`` node per wrapper call of the eager request: the warp's
    shared segment sums (kernel 7, 3 per cost-volume forward), the geo
    forwards' softmaxes and knn, one raster per episode step; no node of a
    plain version; the inputs are ``serve.COMPOSED_KEYS``."""
    art = composed["art"]
    want = _calls(lambda: composed["pipeline"](composed["batch"]))
    nodes = export.kernel_nodes(art)
    assert nodes == want
    assert nodes["segment_sum_shared"] > 0 and nodes["knn"] > 0
    assert nodes["segment_mean_count_image_project"] % \
        composed["cfg"].action_num == 0
    assert art.meta["plain_nodes"] == 0
    assert art.keys == serve.COMPOSED_KEYS


def test_composed_artifact_makes_no_tensor_from_host_data(composed):
    """No node of the composed graph makes a tensor from host data (the
    pose builder's homogeneous 1, the bearing channels' x and z columns):
    on the card it would be a copy from the host that a CUDA graph cannot
    capture."""
    assert export.host_data_nodes(composed["art"]) == 0
