"""Async, atomic checkpointing of trees of tensors, in the JAX package's
format; leaf paths, manifest digests and axis resizing.

Counterpart of the JAX package's ``checkpoint/checkpointer.py``. Layout
per step, the same files, keys, dtype names and digest as the reference's,
so that either package restores what the other saved:

    <dir>/step_<n>.tmp/...   (write)
    <dir>/step_<n>/          (atomic rename on completion)
        manifest.json        (step, leaf paths, shapes, dtypes, digest)
        arrays.npz           (flattened leaves by escaped path; bfloat16
                              stored as a uint16 view)

``save`` copies every leaf to host memory before it returns (so a train
step may update the state in place right after) and writes on a background
thread; ``wait()`` joins before the next save, a restore, or program exit.
``restore`` writes into the template's tensors in place, on their devices.
On a mesh (DTensor leaves) every rank gathers each leaf whole for a save,
rank 0 writes it, and a restore writes each rank's shard of it.

``tree_paths`` (flat escaped leaf paths in the order JAX flattens a tree:
dict keys sorted, list and tuple items by index), ``_digest`` (the
manifest's sha256 prefix) and ``resize_axis`` also serve mid-flight slot
migration (``runtime/migration.py``), whose snapshot manifest and digest
equal the reference's for the same state.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._tree import flatten, unflatten_like
from repro_torch.parallel.sharding import full, is_dtensor, local, local_chunk


def tree_paths(tree: Any) -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` with ``path`` the "/"-joined keys and indices."""
    return [("/".join(str(k) for k in path), leaf)
            for path, leaf in flatten(tree)]


def dtype_name(leaf: Any) -> str:
    """The leaf's dtype as numpy (and the reference's manifest) names it."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _host_array(leaf: Any) -> np.ndarray:
    """A host copy of the leaf as numpy, bfloat16 as a uint16 view; a
    DTensor's whole value, gathered on every rank."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    leaf = full(leaf)
    host = torch.empty(leaf.shape, dtype=leaf.dtype).copy_(leaf.detach())
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


@dataclass
class Checkpointer:
    directory: str
    keep_last: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False,
             extra: Optional[dict] = None) -> None:
        self.wait()
        # snapshot to host memory synchronously, then serialize on the
        # background thread
        paths = tree_paths(tree)
        leaves = [(k, _host_array(v)) for k, v in paths]
        true_dtypes = {k: dtype_name(v) for k, v in paths}
        if dist.is_initialized() and dist.get_rank() != 0:
            return  # every rank gathered the leaves; rank 0 writes them

        def _write():
            try:
                tmp = os.path.join(self.directory, f"step_{step}.tmp")
                final = os.path.join(self.directory, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                arrays = {k: v for k, v in leaves}
                np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
                manifest = {
                    "step": step,
                    "leaves": {k: {"shape": list(v.shape),
                                   "dtype": true_dtypes[k]}
                               for k, v in leaves},
                    "extra": extra or {},
                }
                manifest["digest"] = _digest(manifest["leaves"])
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)  # atomic publish
                self._gc()
            except BaseException as e:  # surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return max(steps) if steps else None

    def restore(self, step: int, template: Any) -> Any:
        """Restore into ``template``'s structure: each tensor leaf of the
        template is overwritten in place (cast to its dtype), any other
        leaf becomes a CPU tensor. Raises on a corrupt manifest or a shape
        that differs from the template's."""
        self.wait()
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("digest") != _digest(manifest["leaves"]):
            raise IOError(f"corrupt checkpoint manifest at step {step}")
        out = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key, tmpl in tree_paths(template):
                out.append(_restore_leaf(key, data[key],
                                         manifest["leaves"][key]["dtype"],
                                         tmpl))
        return unflatten_like(template, out)

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)


def _restore_leaf(key: str, arr: np.ndarray, dtype: str, tmpl: Any) -> Any:
    """One saved leaf into its template: in place into a tensor, cast to
    its dtype; a CPU tensor for any other template leaf."""
    if dtype == "bfloat16":
        host = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        host = torch.from_numpy(np.array(arr))
    if tuple(host.shape) != tuple(np.shape(tmpl)):
        raise ValueError(f"shape mismatch for {key}: ckpt "
                         f"{tuple(host.shape)} vs template "
                         f"{tuple(np.shape(tmpl))}")
    if not isinstance(tmpl, torch.Tensor):
        return host
    if is_dtensor(tmpl):  # this rank's shard of the whole
        host = local_chunk(host, tmpl.placements, tmpl.device_mesh)
    with torch.no_grad():
        local(tmpl).copy_(host)
    return tmpl


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
