"""Checkpoints of an ordered mapping of tensors, in the file layout of
roboticsplayroompybullet_tpu/utils/checkpoint.py.

One .npz holds the leaves as `leaf_0 … leaf_{n-1}` in the mapping's order
and their count as `__n_leaves__`, written to a temporary file and renamed
into place. A JAX pytree is saved with its leaves in jax.tree_util order
(dict keys sorted), so a mapping given in that order is read by the JAX
package's load_pytree, and a file the JAX package wrote loads here onto a
template mapping with the same leaves in the same order.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch


def save_pytree(path: str, tree: Mapping[str, torch.Tensor]) -> None:
    """Write the values of `tree` (tensors or arrays), in its order, to
    `path` (.npz)."""
    leaves = list(tree.values())
    arrays = {f"leaf_{i}": (v.detach().cpu().numpy()
                            if isinstance(v, torch.Tensor) else np.asarray(v))
              for i, v in enumerate(leaves)}
    arrays["__n_leaves__"] = np.asarray(len(leaves))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)              # atomic: no torn checkpoints


def load_pytree(path: str, template: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The leaves saved at `path` under `template`'s keys, in its order,
    each with its template's dtype and device."""
    with np.load(path) as data:
        n = int(data["__n_leaves__"])
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    if len(template) != n:
        raise ValueError(
            f"checkpoint has {n} leaves, template has {len(template)}")
    out = {}
    for (k, t), leaf in zip(template.items(), leaves):
        if tuple(leaf.shape) != tuple(t.shape):
            raise ValueError(f"{k}: checkpoint shape {leaf.shape}, template "
                             f"{tuple(t.shape)}")
        out[k] = torch.as_tensor(leaf, dtype=t.dtype, device=t.device)
    return out
