"""Leaf paths, manifest digests and axis resizing over trees of tensors.

Counterpart of three helpers of the JAX package's
``checkpoint/checkpointer.py``: ``tree_paths`` (flat escaped leaf paths in
the order JAX flattens a tree: dict keys sorted, list and tuple items by
index), ``_digest`` (the manifest's sha256 prefix) and ``resize_axis``.
Mid-flight slot migration (``runtime/migration.py``) builds its snapshot
manifest from them, so a snapshot's manifest and digest equal the
reference's for the same state.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any

import torch


def _flatten(tree: Any, prefix: tuple) -> list[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], prefix + (key,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, item in enumerate(tree):
            out += _flatten(item, prefix + (i,))
        return out
    return [(prefix, tree)]


def tree_paths(tree: Any) -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` with ``path`` the "/"-joined keys and indices."""
    return [("/".join(str(k) for k in path), leaf)
            for path, leaf in _flatten(tree, ())]


def _digest(leaves_manifest: dict) -> str:
    blob = json.dumps(leaves_manifest, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def resize_axis(arr: torch.Tensor, axis: int, new_len: int) -> torch.Tensor:
    """Zero-pad or truncate ``arr`` along ``axis`` to ``new_len`` — the leaf
    reshaping primitive mid-flight slot migration uses to move KV-cache rows
    between engines whose ``max_len`` disagree. Truncation drops the TAIL
    (and returns a view); callers are responsible for only truncating rows
    the consumer can never address (the decode path's per-row causal mask
    makes rows at index >= pos unreachable)."""
    cur = arr.shape[axis]
    if new_len == cur:
        return arr
    if new_len < cur:
        return arr.narrow(axis, 0, new_len)
    pad_shape = list(arr.shape)
    pad_shape[axis] = new_len - cur
    return torch.cat([arr, arr.new_zeros(pad_shape)], dim=axis)
