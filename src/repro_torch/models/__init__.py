"""Models as plain functions on dicts of tensors (dense family)."""
