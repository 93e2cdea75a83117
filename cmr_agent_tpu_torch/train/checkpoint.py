"""Checkpoints of the port (counterpart of the JAX package's
``train/checkpoint.py``), with torch and numpy only.

Layouts, told apart by what is on disk (:func:`port_model_file`), as the
JAX package's ``saved_tree_keys`` tells its Orbax layouts apart:

* a train checkpoint: a directory of two ``torch.save`` files, the JAX
  package's two-tree layout: ``path/model`` (the module's state and the
  step) and ``path/opt`` (the optimizer's moments and count), written by
  :func:`save_train_checkpoint`;
* a stepless model snapshot: a directory whose ``path/model`` file holds
  the module's state alone (:func:`save_model_snapshot`; the convergence
  demo's ``--save-geo`` / ``--save-agent``);
* a weight export. The JAX package's checkpoints are Orbax trees, which
  this package cannot read. ``tests/export_torch_weights.py`` (run where
  the JAX package and ``orbax`` are installed) exports the committed trees
  that the flagship evaluation loads into
  ``cmr_agent_tpu_torch/weights/*.npz``, keyed by flax path, and lists
  them in ``weights/manifest.json``; such an export is found from its file
  or from the Orbax directory it came from. An Orbax tree without an
  export raises.

:func:`restore_model_variables` returns the JAX-layout numpy tree of any
of them; :func:`restore_state_dict` the port module's ``state_dict`` (a
port file's own tensors, bit for bit), also of a reference ``.pth``;
:func:`load_module_variables` puts a JAX-layout tree into a module
through the weight bridge (:func:`.convert.flax_to_state_dict`).

Restoring a train state from ``model`` alone (no ``opt``) sets the
learning-rate schedule's position to the restored step and leaves Adam's
moments fresh, as the JAX package's ``_fastforward_schedule`` does; from a
stepless snapshot the step stays where the state was too.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from . import convert

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
    """A checkpoint's model part (``path/model``: a port file or an Orbax
    subtree), or ``path`` itself where there is none. Always absolute."""
    path = os.path.abspath(path)
    sub = os.path.join(path, "model")
    return sub if os.path.exists(sub) else path


def port_model_file(path: str) -> Optional[str]:
    """The ``torch.save`` file of a train checkpoint or a snapshot at
    ``path`` (its ``model`` file, or ``path`` itself where that is such a
    file), or None for a weight export, an Orbax tree, a ``.pth`` or
    nothing. An Orbax ``model`` is a directory, never a file."""
    mp = model_tree_path(path)
    if os.path.isfile(mp) and not mp.endswith((".npz", ".pth")):
        return mp
    return None


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


def _load_port_file(path: str, device="cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=device, weights_only=True)


def restore_model_variables(path: str, cfg: Optional[Config] = None,
                            which: Optional[str] = None) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` (and ``"step"`` where the checkpoint
    saved one) as the JAX package lays them out, numpy leaves, from any
    layout of the module docstring. A port file (a train checkpoint or a
    snapshot) goes through the weight bridge's name map, so it needs the
    module's ``cfg`` and ``which`` (as in
    :func:`.convert.flax_to_state_dict`); an export needs neither (see
    :func:`export_path`)."""
    f = port_model_file(path)
    if f is None:
        with np.load(export_path(path)) as z:
            return _unflatten({k: z[k] for k in z.files})
    if cfg is None or which is None:
        raise ValueError(f"{path} is a port checkpoint: name the module "
                         f"(cfg and which) to lay it out as the JAX "
                         f"package does")
    saved = _load_port_file(f)
    out = convert.state_dict_to_flax(cfg, saved["module"], which)
    if "step" in saved:
        out["step"] = np.asarray(saved["step"], np.int32)
    return out


def restore_state_dict(path: str, cfg: Config, which: str
                       ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's ``which`` module (``"multihead"``,
    ``"agent"``, ``"itermodel"``) saved at ``path``, on the CPU: a port
    train checkpoint's or snapshot's own tensors, bit for bit; a reference
    ``.pth`` through :func:`.convert.torch_to_state_dict`; a weight export
    (or its Orbax tree) through the weight bridge."""
    if str(path).endswith(".pth"):
        return convert.torch_to_state_dict(cfg, path, which)
    f = port_model_file(path)
    if f is not None:
        return _load_port_file(f)["module"]
    return convert.flax_to_state_dict(cfg, restore_model_variables(path),
                                      which)


def saved_tree_keys(path: str) -> frozenset:
    """Top-level keys of what is saved at ``path``: a port file's
    (``{"module", "step"}`` of a train checkpoint, ``{"module"}`` of a
    snapshot) or a weight export's (or the Orbax tree it came from)."""
    f = port_model_file(path)
    if f is not None:
        return frozenset(_load_port_file(f))
    with np.load(export_path(path)) as z:
        return frozenset(k.split("/")[0] for k in z.files)


def load_module_variables(module: torch.nn.Module, cfg: Config, variables,
                          which: str) -> torch.nn.Module:
    """Load the JAX-layout ``variables`` into ``module`` (a
    ``MultiHeadModel``, ``CMRAgent`` or ``IterModel``: ``which`` as in
    :func:`.convert.flax_to_state_dict`), in place, on the module's
    device. Every parameter and buffer must be assigned."""
    sd = convert.flax_to_state_dict(cfg, variables, which)
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


def save_model_snapshot(path: str, state_dict: Dict[str, torch.Tensor]
                        ) -> None:
    """A stepless model snapshot: ``path/model`` holds ``state_dict``
    (parameters and BatchNorm buffers) and no step, replaced whole (written
    beside it, then renamed over it), so a run that dies while saving
    keeps its previous snapshot."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, "model")
    torch.save({"module": state_dict}, target + ".tmp")
    os.replace(target + ".tmp", target)


def restore_train_checkpoint(path: str, state) -> Tuple[Any, bool]:
    """Restore :func:`save_train_checkpoint` or :func:`save_model_snapshot`
    output onto ``state`` in place. Returns ``(state, opt_restored)``:
    where ``path/opt`` is missing, the optimizer keeps its fresh moments
    (``opt_restored`` False) and the schedule's position moves to the
    restored step, or, from a stepless snapshot, stays where it was."""
    f = port_model_file(path)
    if f is None:
        raise FileNotFoundError(f"{path} holds no port train checkpoint or "
                                f"snapshot (a `model` file)")
    module = _module(state)
    dev = next(module.parameters()).device
    m = _load_port_file(f, dev)
    module.load_state_dict(m["module"], strict=True)
    opt_path = os.path.join(path, "opt")
    if os.path.isfile(opt_path):
        o = torch.load(opt_path, map_location=dev, weights_only=True)
        state.optimizer.load_state_dict(o["optimizer"])
        state.optimizer.count = int(o["count"])
        return state, True
    if "step" in m:
        state.optimizer.count = int(m["step"])
    return state, False
