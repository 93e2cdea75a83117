"""The factored image raster (kernel 6b), the generic segment mean, the
profiling helpers and the measuring tools of the port, on the CPU.

The raster's plain version, its mean/count form and its gradient are held
against the JAX package's Pallas kernel in ``interpret=True`` mode; the
port's wrappers take their plain versions because the tensors lie on the
CPU. Inputs are made with numpy from fixed seeds and handed to both
packages. The tools run at a tiny size with ``--device cpu``; without it
they ask for CUDA and raise here.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmr_agent_tpu.ops import pallas_kernels as pk
from cmr_agent_tpu_torch.ops import kernels
from cmr_agent_tpu_torch.utils import profiling

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _raster_inputs(seed: int, h: int, w: int, n: int = 300, f: int = 6):
    """Rows and pixel ids with every kind of routed-out id: ``h*w``, above
    it, negative, and a dead tail (the valid-first layout's)."""
    rng = np.random.default_rng(seed)
    hw = h * w
    data = rng.normal(size=(2, n, f)).astype(np.float32)
    ids = rng.integers(0, hw, size=(2, n)).astype(np.int32)
    ids[:, :10] = hw
    ids[:, 10:20] = hw + rng.integers(1, 1000, size=10)
    ids[:, 20:30] = -rng.integers(1, 2 * w, size=10)
    ids[0, n - 64:] = hw
    ids[1, n - 100:] = hw + 7
    return data, ids


def _jax_dtype(mode):
    return None if mode == "float32" else jnp.bfloat16


def _torch_dtype(mode):
    return None if mode == "float32" else torch.bfloat16


SHAPES = [(5, 16), (3, 128)]


@pytest.mark.parametrize("hw", SHAPES, ids=["5x16", "3x128"])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_segment_sum_image_plain_matches_jax(mode, hw):
    """rtol 1e-5 atol 1e-6 (f32 sums in another order; bf16: both round the
    rows once and sum in f32); pixels no row lands in are exactly 0."""
    h, w = hw
    data, ids = _raster_inputs(21, h, w)
    got = kernels.segment_sum_image(_t(data), _t(ids), h, w,
                                    _torch_dtype(mode)).numpy()
    want = np.asarray(pk.segment_sum_image_fused(
        jnp.asarray(data), jnp.asarray(ids), h, w, 128, True,
        _jax_dtype(mode), True))
    assert got.shape == want.shape == (2, h * w, data.shape[-1])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    landed = np.zeros((2, h * w), bool)
    for b in range(2):
        ok = (ids[b] >= 0) & (ids[b] < h * w)
        landed[b, ids[b][ok]] = True
    assert (~landed).any() and np.all(got[~landed] == 0.0)


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_segment_mean_count_image_factored_matches_jax(mode):
    """Counts exact, means rtol 1e-5, against
    ``segment_mean_count_image_fused(factored=True)``."""
    h, w = 5, 16
    data, ids = _raster_inputs(22, h, w)
    got_m, got_c = kernels.segment_mean_count_image(
        _t(data), _t(ids), h, w, _torch_dtype(mode), factored=True)
    want_m, want_c = pk.segment_mean_count_image_fused(
        jnp.asarray(data), jnp.asarray(ids), h, w, 128, True,
        _jax_dtype(mode), True)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    landed = ((ids >= 0) & (ids < h * w)).sum()
    assert got_c.numpy().sum() == landed
    np.testing.assert_allclose(got_m.detach().numpy(), np.asarray(want_m),
                               rtol=RTOL, atol=ATOL)
    plain_m, plain_c = kernels.segment_mean_count_image_plain(
        _t(data), _t(ids), h, w, _torch_dtype(mode), factored=True)
    np.testing.assert_array_equal(plain_c.numpy(), got_c.numpy())
    np.testing.assert_array_equal(plain_m.numpy(), got_m.detach().numpy())


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_segment_sum_image_gradient_matches_jax(mode):
    """Torch autograd through :class:`SegmentSumImageFn` against
    ``jax.vjp`` of the factored kernel: exact (a row gather), zero for
    routed-out rows; the bf16 rounding differentiates as the identity."""
    h, w = 5, 16
    data, ids = _raster_inputs(23, h, w)
    g = np.random.default_rng(24).normal(
        size=(2, h * w, data.shape[-1])).astype(np.float32)

    def fwd(d):
        return pk.segment_sum_image_fused(d, jnp.asarray(ids), h, w, 128,
                                          True, _jax_dtype(mode), True)

    _, vjp = jax.vjp(fwd, jnp.asarray(data))
    (want,) = vjp(jnp.asarray(g))
    d = _t(data).requires_grad_()
    kernels.SegmentSumImageFn.apply(d, _t(ids), h, w,
                                    _torch_dtype(mode)).backward(_t(g))
    np.testing.assert_array_equal(d.grad.numpy(), np.asarray(want))
    routed_out = (ids < 0) | (ids >= h * w)
    assert routed_out.any() and np.all(d.grad.numpy()[routed_out] == 0.0)
    # the factored mean's gradient reaches the rows through the same gather
    d2 = _t(data).requires_grad_()
    kernels.segment_mean_count_image(d2, _t(ids), h, w, _torch_dtype(mode),
                                     factored=True)[0].sum().backward()
    assert np.all(d2.grad.numpy()[routed_out] == 0.0)
    assert np.all(d2.grad.numpy()[~routed_out] > 0.0)


@pytest.mark.parametrize("case", ["int8", "wide"])
@pytest.mark.parametrize("package", ["jax", "torch"])
def test_factored_raster_refusals(package, case):
    """int8 (flat kernel only) and ``w > 128`` raise ``ValueError`` in both
    packages."""
    h, w = (5, 16) if case == "int8" else (2, 129)
    data, ids = _raster_inputs(25, h, w, n=64)
    if package == "jax":
        dt = jnp.int8 if case == "int8" else None
        with pytest.raises(ValueError):
            pk.segment_sum_image_fused(jnp.asarray(data), jnp.asarray(ids),
                                       h, w, 64, True, dt, True)
    else:
        dt = torch.int8 if case == "int8" else None
        with pytest.raises(ValueError):
            kernels.segment_sum_image(_t(data), _t(ids), h, w, dt)
        with pytest.raises(ValueError):
            kernels.segment_mean_count_image(_t(data), _t(ids), h, w, dt,
                                             factored=True)


@pytest.mark.parametrize("hw", SHAPES, ids=["5x16", "3x128"])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_factored_plain_mean_equals_flat_bit_for_bit(mode, hw):
    """The plain ones-column form (``factored=True``) and the plain flat
    raster run the same CPU ``scatter_add_`` in row order: the same bits,
    counts and means."""
    h, w = hw
    data, ids = _raster_inputs(27, h, w)
    args = (_t(data), _t(ids), h, w, _torch_dtype(mode))
    fact_m, fact_c = kernels.segment_mean_count_image_plain(*args,
                                                            factored=True)
    flat_m, flat_c = kernels.segment_mean_count_image_plain(*args)
    assert torch.equal(fact_c, flat_c) and torch.equal(fact_m, flat_m)


@pytest.mark.parametrize("hw", SHAPES, ids=["5x16", "3x128"])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_jax_factored_and_flat_means_agree(mode, hw):
    """The two TPU kernels (factored and flat ``segment_sum_image_fused``,
    interpret mode) compute one function, so one Hopper kernel serves
    both: counts exact, means rtol 1e-5 atol 1e-6 (sums in another
    order)."""
    h, w = hw
    data, ids = _raster_inputs(28, h, w)
    fact_m, fact_c = pk.segment_mean_count_image_fused(
        jnp.asarray(data), jnp.asarray(ids), h, w, 128, True,
        _jax_dtype(mode), True)
    flat_m, flat_c = pk.segment_mean_count_image_fused(
        jnp.asarray(data), jnp.asarray(ids), h, w, 128, False,
        _jax_dtype(mode), True)
    np.testing.assert_array_equal(np.asarray(fact_c), np.asarray(flat_c))
    assert np.asarray(fact_c).sum() == ((ids >= 0) & (ids < h * w)).sum()
    np.testing.assert_allclose(np.asarray(fact_m), np.asarray(flat_m),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_factored_mean_function_matches_jax(mode):
    """:class:`SegmentMeanCountImageFn` (the route of
    ``segment_mean_count_image(factored=True)`` on CUDA tensors, here on
    the CPU): means and counts the ones-column wrapper's bits; its gradient
    (the gather of ``g / max(count, 1)``) equal to ``jax.vjp`` of the
    factored Pallas mean, zero for routed-out rows."""
    h, w = 3, 128
    data, ids = _raster_inputs(30, h, w)
    g = np.random.default_rng(31).normal(
        size=(2, h * w, data.shape[-1])).astype(np.float32)
    d = _t(data).requires_grad_()
    got_m, got_c = kernels.SegmentMeanCountImageFn.apply(
        d, _t(ids), h, w, _torch_dtype(mode))
    want_m, want_c = kernels.segment_mean_count_image(
        _t(data), _t(ids), h, w, _torch_dtype(mode), factored=True)
    assert torch.equal(got_c, want_c) and torch.equal(got_m.detach(), want_m)
    got_m.backward(_t(g))

    def means(x):
        return pk.segment_mean_count_image_fused(
            x, jnp.asarray(ids), h, w, 128, True, _jax_dtype(mode), True)[0]

    _, vjp = jax.vjp(means, jnp.asarray(data))
    (want,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(d.grad.numpy(), np.asarray(want))
    routed_out = (ids < 0) | (ids >= h * w)
    assert routed_out.any() and np.all(d.grad.numpy()[routed_out] == 0.0)


@pytest.mark.parametrize("case", ["int8", "wide"])
def test_factored_card_route_refuses(case, monkeypatch):
    """On CUDA tensors (``_on_cuda`` made true here) ``segment_sum_image``
    and ``segment_mean_count_image(factored=True)`` refuse int8 and
    ``w > 128`` with ``ValueError`` as the JAX package does, before any
    kernel is reached."""
    h, w = (5, 16) if case == "int8" else (2, 129)
    data, ids = _raster_inputs(32, h, w, n=64)
    dt = torch.int8 if case == "int8" else None

    def no_launch(*args, **kwargs):
        raise AssertionError("a kernel was reached")

    monkeypatch.setattr(kernels, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(kernels, "_image_raster", no_launch)
    monkeypatch.setattr(kernels, "_launch", no_launch)
    with pytest.raises(ValueError):
        kernels.segment_sum_image(_t(data), _t(ids), h, w, dt)
    with pytest.raises(ValueError):
        kernels.segment_mean_count_image(_t(data), _t(ids), h, w, dt,
                                         factored=True)


def test_segment_mean_count_matches_jax():
    """The generic segment mean (raster_probe's "base"): counts exact,
    means rtol 1e-5, against ``segment_mean_count_fused``."""
    rng = np.random.default_rng(26)
    b, n, f, m = 2, 400, 5, 37
    data = rng.normal(size=(b, n, f)).astype(np.float32)
    idx = rng.integers(0, m - 4, size=(b, n)).astype(np.int32)
    idx[:, :15] = m
    idx[:, 15:25] = m + 9
    got_m, got_c = kernels.segment_mean_count(_t(data), _t(idx), m)
    want_m, want_c = pk.segment_mean_count_fused(
        jnp.asarray(data), jnp.asarray(idx), m, 128, True)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert got_c.numpy().sum() == b * (n - 25)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=RTOL,
                               atol=ATOL)
    assert np.all(got_m.numpy()[:, m - 4:] == 0.0)


def test_phase_timer_counts_and_report():
    timer = profiling.PhaseTimer(sync=True)
    for _ in range(3):
        with timer("raster", result=torch.zeros(2)):
            torch.ones(64).sum()
    with timer("episode"):
        pass
    assert timer.counts == {"raster": 3, "episode": 1}
    assert all(t >= 0.0 for t in timer.totals.values())
    lines = timer.report().splitlines()
    assert len(lines) == 2 and any("x3" in ln and "raster" in ln
                                   for ln in lines)
    timer.reset()
    assert timer.report() == ""


def test_trace_context_writes_a_chrome_trace(tmp_path):
    with profiling.trace_context(None):
        torch.ones(8).sum()                      # falsy logdir: no-op
    assert not any(tmp_path.iterdir())
    logdir = tmp_path / "trace"
    with profiling.trace_context(str(logdir)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    trace = json.loads((logdir / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
    rows, wall_ms = profiling.profile_device(
        lambda: torch.randn(64, 64) @ torch.randn(64, 64), "cpu", iters=2)
    assert wall_ms > 0.0 and any("mm" in k for k in rows)
    assert all(ms >= 0.0 and n >= 1 for ms, n in rows.values())


class _RawEvent:
    """The part of a profiler's raw event that ``kernel_rows`` reads."""

    def __init__(self, name, device="cuda", start=0, end=0, threads=(1, 1),
                 asynchronous=False, annotation=False, hidden=False):
        from torch.autograd import DeviceType
        self._name, self._start, self._end = name, start, end
        self._device = (DeviceType.CUDA if device == "cuda"
                        else DeviceType.CPU)
        self._threads, self._async = threads, asynchronous
        self._annotation, self._hidden = annotation, hidden

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def start_thread_id(self):
        return self._threads[0]

    def end_thread_id(self):
        return self._threads[1]

    def is_async(self):
        return self._async

    def is_user_annotation(self):
        return self._annotation

    def is_hidden_event(self):
        return self._hidden


def test_kernel_rows_groups_the_cards_raw_events():
    """The card's rows from raw events: summed by name in ms, counted, the
    host's rows, user annotations, hidden and filtered names and
    ``Optimizer.`` rows left out, an asynchronous row counted with no
    time, ``ProfilerStep#N`` under ``ProfilerStep*`` as ``key_averages``
    names it."""
    rows = profiling.kernel_rows([
        _RawEvent("knn_kernel", start=1_000, end=251_000),
        _RawEvent("knn_kernel", start=300_000, end=800_000),
        _RawEvent("knn_kernel", device="cpu", start=0, end=9_000_000),
        _RawEvent("Memcpy HtoD", start=0, end=2_000),
        _RawEvent("gemm", start=0, end=7_000_000, asynchronous=True),
        _RawEvent("gemm", start=0, end=7_000_000, threads=(1, 2)),
        _RawEvent("gemm", start=0, end=3_000_000),
        _RawEvent("region", start=0, end=5_000_000, annotation=True),
        _RawEvent("hidden", start=0, end=5_000_000, hidden=True),
        _RawEvent("[memory]", start=0, end=5_000_000),
        _RawEvent("Optimizer.step#Adam.step", start=0, end=5_000_000),
        _RawEvent("ProfilerStep#3", start=0, end=4_000),
        _RawEvent("ProfilerStep#4", start=0, end=6_000)])
    assert rows == {"knn_kernel": (0.75, 2), "Memcpy HtoD": (0.002, 1),
                    "gemm": (3.0, 3), "ProfilerStep*": (0.01, 2)}
    assert profiling.kernel_rows([]) == {}


def test_device_time_by_name_cuda_rows_of_a_host_profile_are_empty():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.randn(32, 32) @ torch.randn(32, 32)
    assert profiling.device_time_by_name(prof, "cuda") == {}
    assert any("mm" in k for k in profiling.device_time_by_name(prof, "cpu"))


def _tool(name):
    import importlib
    return importlib.import_module(f"cmr_agent_tpu_torch.tools.{name}")


TOOL_ARGS = {
    "raster_probe": ["--batch", "2", "--n", "512", "--f", "8", "--h", "4",
                     "--w", "16", "--iters", "1", "--valid-frac", "0.5"],
    "train_probe": ["--config", "micro", "--batch", "2", "--steps", "1"],
    "episode_trace": ["--config", "micro", "--batch", "2", "--iters", "1",
                      "--dtype", "float32",
                      "--top", "5"],
    "segment_turns": ["--config", "micro", "--batch", "2", "--iters", "1",
                      "--hypotheses", "3"],
}


def test_raster_probe_runs_on_cpu(capsys):
    out = _tool("raster_probe").main(TOOL_ARGS["raster_probe"]
                                     + ["--device", "cpu"])
    cases = ("base", "flat_f32", "flat_bf16", "fact_f32", "fact_bf16",
             "comp_f32", "comp_bf16")
    assert all(out[f"{c}_ms"] > 0.0 for c in cases)
    assert out["best"] in cases and out["best_speedup_vs_base"] >= 1.0
    assert out["valid_frac"] == 0.5 and out["device"] == "cpu"
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(printed) == out
    # the cases compute one function: their means agree on the probe's rows
    feat, ids = _tool("raster_probe").make_inputs(2, 512, 8, 4, 16, 0.5,
                                                  False, "cpu")
    means = {c: fn(feat, ids) for c, fn in
             _tool("raster_probe").cases(4, 16).items()}
    for c in ("flat_f32", "fact_f32", "comp_f32"):
        np.testing.assert_allclose(means[c].numpy(), means["base"].numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_train_probe_runs_on_cpu():
    out = _tool("train_probe").main(TOOL_ARGS["train_probe"]
                                    + ["--device", "cpu"])
    variants = ("pure", "lazylog", "sync", "hostrng", "feed")
    assert set(out["ms_per_step"]) == set(variants)
    assert all(v > 0.0 for v in out["ms_per_step"].values())
    assert set(out["residue_vs_pure_ms"]) == set(variants[1:])
    assert out["batch"] == 2 and out["dtype"] == "float32"
    with pytest.raises(ValueError, match="float32"):
        _tool("train_probe").main(TOOL_ARGS["train_probe"]
                                  + ["--device", "cpu", "--dtype",
                                     "bfloat16"])


def test_episode_trace_runs_on_cpu():
    out = _tool("episode_trace").main(TOOL_ARGS["episode_trace"]
                                      + ["--device", "cpu"])
    assert out["total_device_ms_per_iter"] is None    # no card
    assert out["wall_ms_per_iter"] > 0.0
    assert 1 <= len(out["top"]) <= 5
    for row in out["top"]:
        assert set(row) == {"op", "total_ms", "per_iter_ms", "count", "pct"}
    assert sum(r["pct"] for r in out["top"]) <= 100.0 + 1e-6


def test_segment_turns_runs_on_cpu(capsys):
    """The turns tool at micro size: every part runs, the request's
    kernel-7 calls, the geo forward's knn call and the episode's raster
    calls are captured, and the wrappers (their plain versions here) give
    the same bits twice."""
    out = _tool("segment_turns").main(TOOL_ARGS["segment_turns"]
                                      + ["--device", "cpu"])
    assert [r["kernel"] for r in out["uniform"]] == ["segment_sum"] * 3 + [
        "segment_sum_shared"]
    assert all(r["ms"] > 0.0 and r["device_ms"] is None
               for r in out["uniform"])
    assert out["request"]["calls"] > 0 and out["request"]["same_bits"]
    assert out["request"]["kernel_in_request_device_ms"] is None
    assert out["geo"]["same_bits"] and out["device"] == "cpu"
    assert out["knn"]["knn_uniform"]["calls"] == 1
    assert out["knn"]["knn_path"]["calls"] == 1          # one geo forward
    for part in ("raster_f32", "raster_bf16", "raster_int8"):
        assert out["raster"][part]["calls"] == 1
    # one raster a step of the micro episode
    from cmr_agent_tpu_torch.config import micro_config
    assert out["raster"]["raster_episode"]["calls"] == micro_config(
        ).action_num
    for totals in (out["knn"], out["raster"]):
        assert all(t["same_bits"] and t["ms"] > 0.0 and "device_ms" not in t
                   for t in totals.values())
    assert out["paths"] == {"episode_bf16_int8_device_ms": None,
                            "request_bf16_int8_device_ms": None}
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == out
    rows = [json.loads(ln) for ln in printed[:-1]]
    assert all(r["same_bits"] for r in rows)
    episode = [r for r in rows if r["part"] == "raster_episode"]
    assert all(r["options"] == {"compute_dtype": "torch.int8"}
               and r["valid_rows"] > 0 for r in episode)


def test_segment_turns_parts_run_alone():
    """``--parts`` picks the parts; an unknown part raises."""
    out = _tool("segment_turns").main(TOOL_ARGS["segment_turns"]
                                      + ["--device", "cpu", "--parts",
                                         "knn"])
    assert set(out) == {"tag", "device", "knn"}
    with pytest.raises(ValueError, match="unknown parts"):
        _tool("segment_turns").main(TOOL_ARGS["segment_turns"]
                                    + ["--device", "cpu", "--parts", "nope"])


def test_segment_turns_softmax_image_parts_on_cpu(capsys):
    """The kernel 1 and 6a parts alone at micro size: kernel 1 at the
    serving shape in f32 and bf16 and on each geo forward's 4 calls (the
    bf16 forward hands the plain version bf16 operands, no widening by the
    caller), kernel 6a in three modes and on the captured calls of one
    agent-training run and one "flat" bf16 + int8 episode, each call giving
    the same bits twice."""
    from cmr_agent_tpu_torch.config import micro_config
    cfg = micro_config()
    out = _tool("segment_turns").main(TOOL_ARGS["segment_turns"]
                                      + ["--device", "cpu", "--parts",
                                         "softmax,image"])
    assert set(out) == {"tag", "device", "softmax", "image"}
    soft, image = out["softmax"], out["image"]
    assert soft["softmax_f32"]["calls"] == soft["softmax_bf16"]["calls"] == 1
    assert soft["softmax_geo_float32"]["calls"] == 4
    assert soft["softmax_geo_bfloat16"]["calls"] == 4
    assert soft["geo_forward_float32_device_ms"] is None
    for part in ("image_f32", "image_bf16", "image_int8"):
        assert image[part]["calls"] == 1
    assert image["image_train"]["calls"] == cfg.action_num * \
        cfg.num_trajectory
    assert image["image_flat_episode"]["calls"] == cfg.action_num
    for totals in (soft, image):
        assert all(t["same_bits"] and t["ms"] > 0.0 for t in totals.values()
                   if isinstance(t, dict))
    rows = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()[:-1]]
    geo16 = [r for r in rows if r["part"] == "softmax_geo_bfloat16"]
    assert all(r["dtypes"][:2] == ["torch.bfloat16"] * 2
               and "widened_by_caller" not in r for r in geo16)
    flat = [r for r in rows if r["part"] == "image_flat_episode"]
    assert all(r["landed_rows"] >= 0 and r["device_all_ms"] is None
               for r in flat)


def test_segment_turns_compact_pack_parts_on_cpu(capsys):
    """The kernel 8 and 11 parts alone at micro size: kernel 8 in three
    modes and with every row routed out on the busiest call of an f32
    "compact" episode, then on the captured calls of that episode and of a
    bf16 + int8 one; kernel 11 once; each call giving the same bits
    twice."""
    from cmr_agent_tpu_torch.config import micro_config
    cfg = micro_config()
    out = _tool("segment_turns").main(TOOL_ARGS["segment_turns"]
                                      + ["--device", "cpu", "--parts",
                                         "compact,pack"])
    assert set(out) == {"tag", "device", "compact", "pack"}
    comp = out["compact"]
    for part in ("compact_f32", "compact_bf16", "compact_int8",
                 "compact_routed_out"):
        assert comp[part]["calls"] == 1
    for dtype in ("float32", "bfloat16"):
        assert comp[f"compact_episode_{dtype}"]["calls"] == cfg.action_num
        assert comp[f"episode_{dtype}_device_ms"] is None
    assert out["pack"]["calls"] == 1
    for t in list(comp.values()) + [out["pack"]]:
        assert not isinstance(t, dict) or (t["same_bits"] and t["ms"] > 0.0)
    rows = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()[:-1]]
    routed = [r for r in rows if r["part"] == "compact_routed_out"]
    assert routed[0]["landed_rows"] == 0
    assert rows[-1]["part"] == "pack" and rows[-1]["shape"][0] == [
        2, cfg.num_pt]


def test_segment_turns_factored_part_on_cpu(capsys):
    """The kernel 6b part alone at micro size: ``segment_sum_image`` at
    both layouts in f32 and bf16 with and without the count column, then
    the probe's "fact" and "flat" means in both dtypes, each call giving
    the same bits twice and the two means landing the same rows."""
    from cmr_agent_tpu_torch.config import micro_config
    f = micro_config().embed_dim
    out = _tool("segment_turns").main(TOOL_ARGS["segment_turns"]
                                      + ["--device", "cpu", "--parts",
                                         "factored"])
    assert set(out) == {"tag", "device", "factored"}
    want = [f"factored_{layout}_{mode}_F{width}"
            for layout in ("probe", "train") for width in (f + 1, f)
            for mode in ("f32", "bf16")]
    want += [f"factored_{case}_{mode}" for mode in ("f32", "bf16")
             for case in ("fact", "flat")]
    assert list(out["factored"]) == want
    assert all(t["calls"] == 1 and t["same_bits"] and t["ms"] > 0.0
               for t in out["factored"].values())
    rows = [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()[:-1]]
    sums = [r for r in rows if r["kernel"] == "segment_sum_image"]
    assert len(sums) == 8 and all(r["shape"][0][-1] in (f, f + 1)
                                  for r in sums)
    means = {r["part"]: r for r in rows
             if r["kernel"] == "segment_mean_count_image"}
    for mode in ("f32", "bf16"):
        fact, flat = means[f"factored_fact_{mode}"], means[
            f"factored_flat_{mode}"]
        assert fact["options"] == {"factored": "True"}
        assert fact["landed_rows"] == flat["landed_rows"] > 0


@pytest.mark.parametrize("name", sorted(TOOL_ARGS))
def test_tools_refuse_to_fall_back_to_cpu(name):
    """Without ``--device cpu`` a tool asks for the card; on a host without
    CUDA it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        _tool(name).main(TOOL_ARGS[name])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs a test
    process per core or so, and torch's default of a thread per core in
    each of them oversubscribes the host many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
