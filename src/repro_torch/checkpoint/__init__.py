"""Checkpoint helpers of the port: the leaf paths, manifest digest and
axis resizing that mid-flight slot migration uses. The JAX package's
``Checkpointer`` class serves training and comes with it, in slice 7."""
from repro_torch.checkpoint.checkpointer import resize_axis, tree_paths

__all__ = ["resize_axis", "tree_paths"]
