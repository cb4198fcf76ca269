"""Deterministic sharded synthetic data pipeline.

Counterpart of the JAX package's ``data/pipeline.py``, batch for batch:
every batch is drawn with numpy from a Philox stream seeded per (dataset
seed, step, host, input name), so every host materializes only its slice
of the global batch, any step is reproducible after a restart (a
checkpoint needs only the step counter), and the port's batches are
byte-identical to the reference's. A small background prefetch thread
hides generation latency behind the train step. ``device_put_batch`` moves
a host batch to a device: there is no mesh on one card.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.inputs import batch_structure


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0
    prefetch: int = 2
    # "arithmetic": t_{i+1} = (t_i + k) mod V with per-row k — a *learnable*
    # next-token task, so training shows real convergence.
    # "uniform": i.i.d. tokens (throughput benchmarking).
    task: str = "arithmetic"


class SyntheticLMStream:
    """Infinite deterministic token stream for a (cfg, shape) cell."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec,
                 data_cfg: DataConfig = DataConfig()):
        assert shape.global_batch % data_cfg.num_hosts == 0, (
            "global batch must divide evenly across hosts")
        self.cfg, self.shape, self.dc = cfg, shape, data_cfg
        self.local_batch = shape.global_batch // data_cfg.num_hosts
        self.structure = batch_structure(cfg, shape)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """The host-local slice of the global batch for ``step``."""
        out = {}
        for name, (shp, dt) in self.structure.items():
            local_shape = (self.local_batch,) + tuple(shp[1:])
            ss = np.random.SeedSequence(
                [self.dc.seed, step, self.dc.host_index, _stable_hash(name)])
            rng = np.random.Generator(np.random.Philox(ss))
            if not dt.is_floating_point:
                if self.dc.task == "arithmetic" and len(local_shape) == 2:
                    b, s = local_shape
                    t0 = rng.integers(0, self.cfg.vocab_size, (b, 1))
                    k = rng.integers(1, min(32, self.cfg.vocab_size), (b, 1))
                    seqs = (t0 + k * np.arange(s)[None, :]) % self.cfg.vocab_size
                    out[name] = seqs.astype(np.int32)
                else:
                    out[name] = rng.integers(
                        0, self.cfg.vocab_size, local_shape).astype(np.int32)
            elif name == "loss_mask":
                out[name] = np.ones(local_shape, np.float32)
            else:
                out[name] = rng.standard_normal(local_shape).astype(np.float32)
        if "labels" in out:  # next-token objective over the same stream
            out["labels"] = np.roll(out["tokens"], -1, axis=-1)
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def prefetching(self, start_step: int = 0) -> "PrefetchIterator":
        return PrefetchIterator(self, start_step, self.dc.prefetch)


class PrefetchIterator:
    def __init__(self, stream: SyntheticLMStream, start_step: int, depth: int):
        self._stream = stream
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._stream.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> tuple[int, dict[str, np.ndarray]]:
        return self._q.get()

    def close(self):
        self._stop.set()
        while not self._q.empty():
            self._q.get_nowait()


def _stable_hash(s: str) -> int:
    h = 2166136261
    for ch in s.encode():
        h = (h ^ ch) * 16777619 % (1 << 32)
    return h


def device_put_batch(batch: dict, device) -> dict[str, torch.Tensor]:
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {name: torch.from_numpy(arr).to(device)
            for name, arr in batch.items()}
