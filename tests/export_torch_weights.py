#!/usr/bin/env python3
"""Export the committed Orbax trees of the flagship evaluation (E7,
``runs_r5/README.md``) to numpy files that ``cmr_agent_tpu_torch`` reads
with numpy and torch alone.

    python tests/export_torch_weights.py

Needs the JAX package and ``orbax`` (the card's machine has neither, so it
runs on a host that does). For each tree it restores the model subtree with
the JAX package's ``restore_checkpoint(model_tree_path(p), template)``, the
template made of concrete zero leaves shaped from the tree's own metadata
(``restore_model_variables`` cannot restore a saved ``step`` leaf on a host
other than the one that wrote it), and writes one ``np.savez_compressed``
file into ``cmr_agent_tpu_torch/weights/`` whose keys are the flax paths
(``params/...``, ``batch_stats/...``, ``step``). ``manifest.json`` beside
them records each export's Orbax path, leaf count, size and sha256. The
Orbax trees are only read.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "cmr_agent_tpu_torch" / "weights"
# export file stem -> Orbax tree (relative to the repository root)
TREES = {
    "geo_pi": "runs_r4/geo_pi",
    "geo_45": "runs_r4/geo_45",
    "agent_45": "runs_r4/agent_45",
    "iter_kitti_epoch-1-step-10000": "checkpoint/iter_kitti/epoch-1-step-10000",
}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(_flatten(v, p))
        else:
            out[p] = v
    return out


def restore_tree(orbax_path: str) -> dict:
    """``{flax path: numpy array}`` of the model subtree at ``orbax_path``
    (``params``, ``batch_stats`` and, where saved, ``step``)."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from cmr_agent_tpu.train.checkpoint import (model_tree_path,
                                                restore_checkpoint)
    jax.config.update("jax_platforms", "cpu")
    mp = model_tree_path(str(REPO / orbax_path))
    meta = ocp.StandardCheckpointer().metadata(mp).item_metadata.tree
    template = jax.tree_util.tree_map(
        lambda m: jnp.zeros(tuple(m.shape), m.dtype), dict(meta))
    restored = restore_checkpoint(mp, template=template)
    return {k: np.asarray(v) for k, v in _flatten(restored).items()}


def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for stem, orbax_path in TREES.items():
        flat = restore_tree(orbax_path)
        path = OUT / f"{stem}.npz"
        np.savez_compressed(path, **flat)
        manifest[stem] = {
            "file": path.name, "orbax": orbax_path, "leaves": len(flat),
            "bytes": os.path.getsize(path), "sha256": sha256(path)}
        print(f"{orbax_path} -> {path.relative_to(REPO)} "
              f"({len(flat)} leaves, {manifest[stem]['bytes']} bytes)")
    (OUT / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
