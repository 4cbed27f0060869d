"""Production mesh construction on torch's DeviceMesh.

The counterpart of `repro/launch/mesh.py`, with the reference's mesh
shapes and axis names so that dry-run records compare: 16 x 16
("data", "model") for one pod, 2 x 16 x 16 ("pod", "data", "model") for
two. With no real process group up, the mesh is built on a *fake*
process group of the mesh's size (torch's "fake" backend: this process
is rank 0 of N, collectives return at once), which is what the dry-run
traces against. Functions, not module constants: importing this module
touches no device and no process group.

The roofline constants are the H100 SXM5 80 GB's spec-sheet figures (not
measurements): the dry-run's times are predictions against them.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM5 spec sheet: dense BF16 tensor-core peak (989.4 TFLOP/s
# without sparsity), HBM3 bandwidth 3.35 TB/s, NVLink 4 900 GB/s total
# per GPU = 450 GB/s per direction.
PEAK_FLOPS_BF16 = 989.4e12        # per chip
HBM_BW = 3.35e12                  # bytes/s per chip
ICI_BW = 450e9                    # bytes/s per chip and direction (NVLink)


def _fake_world(n: int) -> None:
    """Make the default process group a fake one of `n` ranks (this
    process rank 0), replacing an earlier fake group of another size. A
    real group stays as it is."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            return
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


def make_mesh(shape, axes, device_type: str = "cpu"):
    """A DeviceMesh of `shape` named `axes`: on the real process group
    when one is up (its world size must equal the mesh's), else on a fake
    group of that size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    _fake_world(n)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_smoke_mesh():
    """(ranks, 1) over the real process group when one is up, on its
    device type; else a fake (1, 1) on the CPU."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() != "fake":
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return make_mesh((dist.get_world_size(), 1), ("data", "model"), dev)
    return make_mesh((1, 1), ("data", "model"))
