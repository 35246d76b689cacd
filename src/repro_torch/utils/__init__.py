"""Small tree utilities used across the port."""
from repro_torch.utils.tree import (
    tree_bytes,
    tree_count,
    tree_flatten_with_paths,
    tree_global_norm,
    tree_zeros_like,
)

__all__ = ["tree_bytes", "tree_count", "tree_flatten_with_paths",
           "tree_global_norm", "tree_zeros_like"]
