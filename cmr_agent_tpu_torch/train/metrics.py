"""Evaluation metrics and metric logging (counterpart of the JAX package's
``train/metrics.py``; reference Test_Agent.py:193-206).

Registration recall is the share of samples with RTE < 5 m and RRE < 10
degrees; RTE / RRE means and deviations are taken over the recalled
samples, medians over all. :class:`MetricLogger` always keeps an in-memory
history and writes tensorboardX scalars only where that package imports.
"""

from __future__ import annotations

import atexit
import weakref
from typing import Dict, List, Optional

import numpy as np


def registration_metrics(rte, rre, rte_thresh: float = 5.0,
                         rre_thresh: float = 10.0) -> Dict[str, float]:
    rte = np.asarray(rte, dtype=np.float64)
    rre = np.asarray(rre, dtype=np.float64)
    mask = (rte < rte_thresh) & (rre < rre_thresh)
    out = {"registration_recall": float(mask.sum() / max(mask.size, 1)),
           "rte_median_all": (float(np.median(rte)) if rte.size
                              else float("nan")),
           "rre_median_all": (float(np.median(rre)) if rre.size
                              else float("nan"))}
    if mask.any():
        out.update(rte_mean=float(rte[mask].mean()),
                   rte_std=float(rte[mask].std()),
                   rre_mean=float(rre[mask].mean()),
                   rre_std=float(rre[mask].std()))
    else:
        out.update(rte_mean=float("nan"), rte_std=float("nan"),
                   rre_mean=float("nan"), rre_std=float("nan"))
    return out


def _numpy(v) -> np.ndarray:
    """A host array of ``v`` (a tensor on any device, or array-like)."""
    if hasattr(v, "detach"):
        v = v.detach().float().cpu()
    return np.asarray(v)


class MetricLogger:
    """Scalar logger: in-memory history, plus tensorboardX where it
    imports."""

    FLUSH_EVERY = 32

    def __init__(self, logdir: Optional[str] = None):
        self.history: Dict[str, List] = {}
        self._pending: List = []
        self._writer = None
        if logdir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._writer = SummaryWriter(log_dir=logdir)
        # an abnormal exit would otherwise drop the lazily buffered entries;
        # a weak reference, so the hook never keeps the logger alive
        atexit.register(_flush_at_exit, weakref.ref(self))

    def log(self, tag: str, value, step: int) -> None:
        self.history.setdefault(tag, []).append((step, float(value)))
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), global_step=step)

    def log_dict(self, metrics: Dict, step: int, prefix: str = "") -> None:
        for k, v in metrics.items():
            self.log(prefix + k, v, step)

    def log_dict_lazy(self, metrics: Dict, step: int, prefix: str = "",
                      steps_axis: bool = False) -> None:
        """Queue ``metrics`` (device tensors allowed) and read them back a
        flush interval later, so that logging does not wait for the card.
        ``steps_axis``: each value is ``[S]``, logged as ``S`` consecutive
        steps from ``step``."""
        self._pending.append((metrics, step, prefix, steps_axis))
        if len(self._pending) >= self.FLUSH_EVERY:
            self.flush()

    def flush(self) -> None:
        for metrics, step, prefix, steps_axis in self._pending:
            vals = {k: _numpy(v) for k, v in metrics.items()}
            if steps_axis:
                s = next(iter(vals.values())).shape[0]
                for i in range(s):
                    self.log_dict({k: float(v[i]) for k, v in vals.items()},
                                  step + i, prefix)
            else:
                self.log_dict({k: float(v) for k, v in vals.items()},
                              step, prefix)
        self._pending.clear()

    def close(self) -> None:
        self.flush()
        if self._writer is not None:
            self._writer.close()


def _flush_at_exit(ref) -> None:
    logger = ref()
    if logger is not None:
        logger.flush()
