"""Named spans of the program's own sites on the profiler's timeline.

`span("ssm.conv")` opens `torch.profiler.record_function("repro_torch.
ssm.conv")` while a torch profiler runs in this process, so the kernels a
site launches can be traced back to it in the same Kineto trace, on the
same clock. With no profiler running it returns one shared no-op context
manager: no allocation, no `RecordFunction`. The profiler is the switch;
there is no flag of the program's own.

The check reads torch's process-wide profiler state (threads that the
profiler records without their own profiler state, such as the saving
pipeline's under an all-threads profile, see it too). torch is imported
at the first call, never with this module: the SMP processes import
`repro_torch.core` modules and must not load torch.
"""
from __future__ import annotations

import contextlib

PREFIX = "repro_torch."
OFF = contextlib.nullcontext()
_profiler = None


def _load():
    global _profiler
    import torch.autograd.profiler as profiler
    _profiler = profiler
    return profiler


def active() -> bool:
    """Whether a torch profiler runs in this process."""
    return (_profiler or _load())._is_profiler_enabled


def span(name: str):
    """A context manager that marks site `name` on the profiler's
    timeline while a profiler runs, else the shared no-op `OFF`."""
    if not active():
        return OFF
    return _profiler.record_function(PREFIX + name)
