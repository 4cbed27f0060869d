"""Disk checkpointing: retention manager + legacy baseline names.

The disk baselines live in the unified facade (`repro_torch.api.disk`);
the reference's historical class names stay importable here, as they are
from `repro.ckpt`.
"""
from repro_torch.api.disk import (
    DiskWriter, PhaseTimes, latest_complete_step, load_checkpoint,
)
from repro_torch.ckpt.manager import CheckpointManager, scan_shards

# legacy aliases (paper §6.1 naming)
AsyncCheckpointer = DiskWriter


class CheckFreqCheckpointer(DiskWriter):
    """Fully asynchronous, unsharded (CheckFreq [15])."""
    name = "checkfreq"

    def __init__(self, out_dir, state_template, **kw):
        kw.pop("shard", None)
        super().__init__(out_dir, state_template, shard=False, **kw)


class TorchSnapshotCheckpointer(DiskWriter):
    """Sharded along DP paths with parallel I/O (TorchSnapshot [16])."""
    name = "torchsnapshot"

    def __init__(self, out_dir, state_template, *, n_ranks, **kw):
        kw.pop("shard", None)
        super().__init__(out_dir, state_template, n_ranks=n_ranks,
                         shard=True, **kw)


__all__ = ["AsyncCheckpointer", "CheckFreqCheckpointer", "CheckpointManager",
           "DiskWriter", "PhaseTimes", "TorchSnapshotCheckpointer",
           "latest_complete_step", "load_checkpoint", "scan_shards"]
