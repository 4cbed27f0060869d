"""repro_torch.api — the unified checkpointing facade.

    from repro_torch.api import CheckpointSpec, CheckpointSession

    spec = CheckpointSpec(backend="reft", ckpt_dir="/tmp/run", sg_size=4)
    with CheckpointSession(spec, state_template) as sess:
        ...
        sess.after_step(state, step, extra_meta=ds.state())

Backends: reft | objstore | sync_disk | async_disk | null.
"""
from repro_torch.api.registry import (
    available_backends, create_checkpointer, register_backend,
)
from repro_torch.api.session import CheckpointSession
from repro_torch.api.types import (
    Checkpointer, CheckpointSpec, CkptEvent, RestoreResult, RestoreTarget,
)

__all__ = [
    "Checkpointer", "CheckpointSpec", "CheckpointSession", "CkptEvent",
    "RestoreResult", "RestoreTarget", "available_backends",
    "create_checkpointer", "register_backend",
]
