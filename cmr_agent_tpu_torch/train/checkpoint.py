"""Checkpoints of the port (counterpart of the JAX package's
``train/checkpoint.py``), with torch and numpy only.

Model variables. The JAX package's checkpoints are Orbax trees, which this
package cannot read. ``tests/export_torch_weights.py`` (run where the JAX
package and ``orbax`` are installed) exports the committed trees that the
flagship evaluation loads into ``cmr_agent_tpu_torch/weights/*.npz``, keyed
by flax path, and lists them in ``weights/manifest.json``.
:func:`restore_model_variables` reads such an export, given its file or the
Orbax directory it came from, and returns the JAX-layout numpy tree;
:func:`load_module_variables` puts that tree into a module through the
weight bridge (:func:`.convert.flax_to_state_dict`).

Train state. A train checkpoint is two ``torch.save`` files, the JAX
package's two-tree layout: ``path/model`` (the module's state and the step)
and ``path/opt`` (the optimizer's moments and count). Restoring from
``model`` alone sets the learning-rate schedule's position to the restored
step and leaves Adam's moments fresh, as the JAX package's
``_fastforward_schedule`` does.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..config import Config
from .convert import flax_to_state_dict

WEIGHTS_DIR = Path(__file__).resolve().parents[1] / "weights"
REPO_ROOT = Path(__file__).resolve().parents[2]
EXPORTER = "tests/export_torch_weights.py"


def manifest() -> Dict[str, dict]:
    """``weights/manifest.json``: export stem -> ``file``, ``orbax`` (the
    tree's path under the repository root), ``leaves``, ``bytes``,
    ``sha256``."""
    return json.loads((WEIGHTS_DIR / "manifest.json").read_text())


def file_sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def model_tree_path(path: str) -> str:
    """A train checkpoint's model part (``path/model``), or ``path``
    itself where there is none. Always absolute."""
    path = os.path.abspath(path)
    sub = os.path.join(path, "model")
    return sub if os.path.exists(sub) else path


def export_path(path: str) -> Path:
    """The ``.npz`` export that ``path`` names: the file itself, or the
    manifest's export of the Orbax tree at ``path`` (or at its parent, for
    a ``.../model`` subtree). Raises ``FileNotFoundError`` where there is
    none; the message names the exporter."""
    if str(path).endswith(".npz"):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no weight export at {path}")
        return Path(path)
    want = Path(os.path.abspath(path))
    candidates = {want, want.parent} if want.name == "model" else {want}
    for entry in manifest().values():
        if (REPO_ROOT / entry["orbax"]).resolve() in {
                c.resolve() for c in candidates}:
            return WEIGHTS_DIR / entry["file"]
    raise FileNotFoundError(
        f"{path} has no export in {WEIGHTS_DIR / 'manifest.json'}: this "
        f"package reads no Orbax tree. Export it with `python {EXPORTER}` "
        f"(add it to TREES there) on a host with the JAX package and orbax")


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def restore_model_variables(path: str) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` (and ``"step"`` where the tree saved
    one) as the JAX package lays them out, numpy leaves, from the export
    ``path`` names (see :func:`export_path`)."""
    with np.load(export_path(path)) as z:
        return _unflatten({k: z[k] for k in z.files})


def saved_tree_keys(path: str) -> frozenset:
    """Top-level keys of what is saved at ``path``: a weight export (or the
    Orbax tree it came from) or a train checkpoint's ``model`` file."""
    mp = model_tree_path(path)
    if os.path.isfile(mp) and not mp.endswith(".npz"):
        return frozenset(torch.load(mp, map_location="cpu",
                                    weights_only=True))
    with np.load(export_path(path)) as z:
        return frozenset(k.split("/")[0] for k in z.files)


def load_module_variables(module: torch.nn.Module, cfg: Config, variables,
                          which: str) -> torch.nn.Module:
    """Load the JAX-layout ``variables`` into ``module`` (a
    ``MultiHeadModel``, ``CMRAgent`` or ``IterModel``: ``which`` as in
    :func:`.convert.flax_to_state_dict`), in place, on the module's
    device. Every parameter and buffer must be assigned."""
    sd = flax_to_state_dict(cfg, variables, which)
    module.load_state_dict(sd, strict=True)
    return module


def _module(state) -> torch.nn.Module:
    """The module of a ``GeoTrainState`` or ``IterTrainState``
    (``model``) or of an ``AgentTrainState`` (``agent``)."""
    return state.model if hasattr(state, "model") else state.agent


def save_train_checkpoint(path: str, state) -> None:
    """Save a ``GeoTrainState``, ``AgentTrainState`` or ``IterTrainState``:
    ``path/model`` holds the module's state and the step, ``path/opt`` the
    optimizer's state and count."""
    module = _module(state)
    os.makedirs(path, exist_ok=True)
    torch.save({"module": module.state_dict(), "step": state.step},
               os.path.join(path, "model"))
    torch.save({"optimizer": state.optimizer.inner.state_dict(),
                "count": state.optimizer.count}, os.path.join(path, "opt"))


def restore_train_checkpoint(path: str, state) -> Tuple[Any, bool]:
    """Restore :func:`save_train_checkpoint` output onto ``state`` in
    place. Returns ``(state, opt_restored)``: where ``path/opt`` is
    missing, the optimizer keeps its fresh moments and only the schedule's
    position moves to the restored step (``opt_restored`` False)."""
    module = _module(state)
    dev = next(module.parameters()).device
    m = torch.load(model_tree_path(path), map_location=dev,
                   weights_only=True)
    module.load_state_dict(m["module"], strict=True)
    opt_path = os.path.join(path, "opt")
    if os.path.isfile(opt_path):
        o = torch.load(opt_path, map_location=dev, weights_only=True)
        state.optimizer.load_state_dict(o["optimizer"])
        state.optimizer.count = int(o["count"])
        return state, True
    state.optimizer.count = int(m["step"])
    return state, False
