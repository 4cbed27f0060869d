"""The traced stretch of a `--trace 1` run: `torch.profiler` over a fixed
run of steps inside the window, read from its Chrome trace.

The harness marks its own spans (`perfbench.feed`, `.step`,
`.after_step`, `.restore`, and `.stretch` around the whole stretch) with
`record_function`, so the device's idle gaps can be named by what the
host was doing. Device time is the union of the kernels', copies' and
memsets' intervals; the idle share is what the stretch leaves over.
"""
from __future__ import annotations

import contextlib
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "perfbench."


def union(intervals):
    """Sorted, merged [(start, end)]."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def short_name(name: str) -> str:
    """A kernel's name without its argument list or template arguments
    past 100 characters."""
    base = name.split("(")[0].strip()
    if base.startswith("void "):
        base = base[5:]
    return base[:100]


def summarize(events: list) -> dict:
    """Chrome trace events -> the stretch's record: `stretch_s`, `busy_s`,
    `kernels` ({short name: [count, seconds]}), `device_ops` and
    `idle_gaps` (the 10 largest, [name, seconds]). Times in the trace are
    microseconds."""
    spans = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"][len(PREFIX):])
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(PREFIX)]
    stretch = [s for s in spans if s[2] == "stretch"]
    if not stretch:
        raise RuntimeError("the trace holds no perfbench.stretch span")
    lo, hi = stretch[0][0], stretch[0][1]
    spans = [s for s in spans if s[2] != "stretch"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    kernels: dict = {}
    for e in dev:
        if e["ts"] >= hi or e["ts"] + e.get("dur", 0) <= lo:
            continue
        k = kernels.setdefault(short_name(e["name"]), [0, 0.0])
        k[0] += 1
        k[1] += e.get("dur", 0) * 1e-6
    busy = union(clip([(e["ts"], e["ts"] + e.get("dur", 0)) for e in dev],
                      lo, hi))
    gaps, prev = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            mid = 0.5 * (prev + a)
            inside = [s for s in spans if s[0] <= mid <= s[1]]
            name = min(inside, key=lambda s: s[1] - s[0])[2] if inside \
                else "between spans"
            gaps.append([name, (a - prev) * 1e-6])
        prev = max(prev, b)
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(([n, v[1]] for n, v in kernels.items()),
                 key=lambda x: -x[1])
    return {"stretch_s": (hi - lo) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": kernels, "device_ops": ops[:10],
            "idle_gaps": gaps[:10]}


class Tracer:
    """Starts and stops the profiler around a stretch of the window, and
    marks the harness's spans while it runs."""

    def __init__(self, tmpdir: str, tag: str):
        self.path = os.path.join(tmpdir, f"perfbench-{tag}-trace.json")
        self.prof = None
        self.done = None
        self.outer = None
        self.record = None
        self.launches = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(PREFIX + name)

    def start(self, launch_counts):
        import torch
        torch.cuda.synchronize()
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])
        self.prof.start()
        self.launches = launch_counts()
        self.outer = torch.profiler.record_function(PREFIX + "stretch")
        self.outer.__enter__()

    def stop(self, launch_counts):
        import torch
        torch.cuda.synchronize()
        self.outer.__exit__(None, None, None)
        after = launch_counts()
        self.prof.stop()
        self.launches = {k: after[k] - self.launches.get(k, 0)
                         for k in after}
        self.done, self.prof = self.prof, None

    def read(self):
        """Export the stopped profile and summarize it (after the
        window: the export takes seconds)."""
        if self.done is None:
            raise RuntimeError("the window ended before the traced stretch "
                               "began")
        self.done.export_chrome_trace(self.path)
        self.done = None
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        self.record = summarize(events)
        self.record["launches"] = self.launches
