"""Distributed-sharding layer: mesh-aware spec adaptation + rule tables
on torch's DeviceMesh and DTensor."""
from repro_torch.dist.api import P, adapt_spec, shard, use_mesh

__all__ = ["P", "adapt_spec", "shard", "use_mesh"]
