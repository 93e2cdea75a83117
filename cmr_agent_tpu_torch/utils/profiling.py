"""Timing and tracing hooks of the port (PyTorch twin of the JAX package's
``utils/profiling.py``).

* :func:`device_sync` — wait for the card (``torch.cuda.synchronize``); on
  the CPU there is nothing to wait for.
* :class:`PhaseTimer` — named phase accumulation, optionally synchronised.
* :func:`trace_context` — a ``torch.profiler`` trace of a code region,
  written as a Chrome trace.
* :func:`cuda_ms` — a call's mean device time from CUDA events.
* :func:`profile_device` / :func:`device_time_by_name` — device time of a
  call by kernel name from ``torch.profiler`` (CUPTI); :func:`kernel_rows`
  reads the card's rows from the profiler's raw events.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple

import torch


def _device_of(x) -> Optional[torch.device]:
    """The device ``x`` names: a tensor's, a ``torch.device``, a device
    string, or the first tensor of a dict, list or tuple."""
    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, (torch.device, str)):
        return torch.device(x)
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            dev = _device_of(v)
            if dev is not None:
                return dev
    return None


def device_sync(x=None) -> None:
    """Wait until the card has finished the work queued so far:
    ``torch.cuda.synchronize`` on the CUDA device ``x`` lies on or names
    (see :func:`_device_of`); with ``x`` None, on the current CUDA device
    once CUDA is in use. A CPU device has nothing to wait for."""
    dev = _device_of(x)
    if dev is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif dev.type == "cuda":
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulate wall time per named phase.

    Example::

        timer = PhaseTimer(sync=True)
        with timer("geo_forward"):
            out = model(batch)
        print(timer.report())
    """

    def __init__(self, sync: bool = False):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        if self.sync:
            device_sync(result)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:30s} {t:8.3f}s total  {t / c * 1e3:8.2f}ms/call"
                         f"  x{c}")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace_context(logdir: Optional[str]):
    """``torch.profiler`` capture of the region (CPU, and CUDA where there
    is a card), written to ``<logdir>/trace.json`` as a Chrome trace;
    no-op when ``logdir`` is falsy."""
    if not logdir:
        yield
        return
    from torch.profiler import profile
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield
        device_sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def cuda_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean device time of ``fn`` per call over ``iters`` calls, from CUDA
    events around the run, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_by_name(prof, device: str = "cuda"
                        ) -> Dict[str, Tuple[float, int]]:
    """``{name: (ms, count)}`` of a finished ``torch.profiler.profile``'s
    rows that ran on ``device``: on "cuda" its kernels, copies and memsets
    (device self time); on "cpu" the host ops' self time. User annotations
    (``Optimizer.step#Adam.step``) span rows already counted and are left
    out.

    The card's rows are read from the profiler's raw events
    (:func:`kernel_rows`): ``key_averages`` first builds the host ops' tree,
    which took 48–77 s after one profiled call of 4–10 s on an H100 host.
    """
    from torch.autograd import DeviceType
    if device == "cuda":
        return kernel_rows(prof.profiler.kineto_results.events())
    out: Dict[str, Tuple[float, int]] = {}
    for e in prof.key_averages():
        if (getattr(e, "device_type", None) != DeviceType.CPU
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        ms, n = out.get(e.key, (0.0, 0))
        out[e.key] = (ms + e.self_cpu_time_total / 1e3, n + e.count)
    return out


def kernel_rows(events) -> Dict[str, Tuple[float, int]]:
    """``{name: (ms, count)}`` of the CUDA rows among a profile's raw
    events (``prof.profiler.kineto_results.events()``), the rows
    ``key_averages`` gives them: the names it filters or hides and the
    user annotations left out, an asynchronous row counted with no time."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    out: Dict[str, Tuple[float, int]] = {}
    for e in events:
        if (e.device_type() != DeviceType.CUDA or _filter_name(e.name())
                or getattr(e, "is_hidden_event", lambda: False)()
                or e.is_user_annotation()):
            continue
        key = _rewrite_name(name=e.name(), with_wildcard=True)
        if key.startswith("Optimizer."):
            continue
        asynchronous = (e.is_async()
                        or e.start_thread_id() != e.end_thread_id())
        ms, n = out.get(key, (0.0, 0))
        out[key] = (ms + (0.0 if asynchronous
                          else (e.end_ns() - e.start_ns()) / 1e6), n + 1)
    return out


def profile_device(fn: Callable[[], object], device: str = "cuda",
                   iters: int = 1) -> Tuple[Dict[str, Tuple[float, int]],
                                            float]:
    """``iters`` calls of ``fn`` under ``torch.profiler``, between two
    synchronisations: ``(device_time_by_name(prof, device), wall ms of the
    calls)``. The profiler slows the host's launches, so the wall time is
    the profiled one."""
    from torch.profiler import profile
    with profile(activities=_activities()) as prof:
        device_sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        device_sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_time_by_name(prof, torch.device(device).type), wall_ms
