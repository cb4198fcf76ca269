"""Checkpointing of the port: the ``Checkpointer`` of the training path,
and the leaf paths, manifest digest and axis resizing that mid-flight slot
migration uses."""
from repro_torch.checkpoint.checkpointer import (
    Checkpointer, resize_axis, tree_paths,
)

__all__ = ["Checkpointer", "resize_axis", "tree_paths"]
