"""Where the device time of a traced stretch went, by the program's own
sites, and what the program was doing in each idle gap.

The program marks its sites with `repro_torch.core.spans.span`: Chrome
trace `user_annotation` events named `repro_torch.<site>`, on the same
clock as the kernels. Each kernel, copy and memset is joined by its
`correlation` to the runtime call that launched it; the call's `External
id` names the CPU op or span it was made in, and so the launching thread
(the call's own thread id can be that of an exited thread whose id the
profiler saw first: the saving path's threads live for one flight). The
event's site is the innermost of the program spans and the backward
functions (`cpu_op`s of the autograd engine that carry a `Sequence
number`) enclosing the launch on the launching thread:

1. a program span is the site (the forward; under `remat` also a layer's
   forward recomputed in the backward, on autograd's thread);
2. a backward function stands for the forward op of its number on the
   thread its `Fwd thread id` names, whose site is the innermost program
   span enclosing that op on its own thread;
3. with neither, `(none)`.

So a site's device time is its forward, its recompute and its backward
together. An idle gap keeps the harness span as its name's first part;
where a program span on the trainer's thread (the one that opened
`perfbench.stretch`) covers the gap's midpoint the name becomes
`<harness span>/<innermost program span>`. Spans on other threads never
name a gap; they are listed beside it.

    python3 perfbench/sites.py --workload <cell> --seed <n> --seconds <s>

runs a cell as `run.py --trace 1` does, with a profiler that records
every thread where torch offers it, and prints `[regions]`, `[sites]`,
`[site-kernels]` and `[gaps]` on standard error before run.py's result
line, whose `idle_gaps` carry the names above. `run.py` itself does not
call this module. Only the standard library is imported at module
level: the SMP processes of a session import the main module again.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

PROGRAM = "repro_torch."
HARNESS = "perfbench."
NONE = "(none)"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
EVALUATE = "autograd::engine::evaluate_function:"
# the per-layer figures of the no-save cell: a site's device ms a step
FIGURES = {"rms_norm_ms": "model.rms_norm", "ssm_conv_ms": "ssm.conv",
           "ssd_glue_ms": "ssm.glue", "loss_ms": "model.loss",
           "adam_ms": "optim.adam"}


def innermost(intervals, points) -> dict:
    """One thread's nested intervals [(start, end, label)] and points
    [(t, key)] -> {key: the innermost interval holding t, or None}."""
    ivs = sorted(intervals, key=lambda s: (s[0], -s[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(points, key=lambda p: p[0]):
        while i < len(ivs) and ivs[i][0] <= t:
            while stack and stack[-1][1] < ivs[i][0]:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = stack[-1] if stack else None
    return out


def _thread(e):
    return e.get("pid"), e.get("tid")


def _end(e):
    return e["ts"] + e.get("dur", 0)


def _is_backward(e) -> bool:
    args = e.get("args", {})
    return e["name"].startswith(EVALUATE) or bool(args.get("Fwd thread id"))


class Trace:
    """The events of one exported trace, grouped for the site rules."""

    def __init__(self, events: list):
        self.spans: dict = {}        # thread -> [(start, end, site)]
        self.harness = []            # [(start, end, name, thread)]
        self.ops: dict = {}          # thread -> [(start, end, op event)]
        self.launches = {}           # correlation -> (thread, ts)
        self.device = []
        made_in = {}                 # External id -> thread
        ext = {}                     # correlation -> External id
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat"), str(e.get("name", ""))
            args = e.get("args", {})
            if cat in ("cpu_op", "user_annotation") and "External id" in args:
                made_in[args["External id"]] = _thread(e)
            if cat == "user_annotation" and name.startswith(PROGRAM):
                self.spans.setdefault(_thread(e), []).append(
                    (e["ts"], _end(e), name[len(PROGRAM):]))
            elif cat == "user_annotation" and name.startswith(HARNESS):
                self.harness.append((e["ts"], _end(e), name[len(HARNESS):],
                                     _thread(e)))
            elif cat == "cpu_op" and "Sequence number" in args:
                self.ops.setdefault(_thread(e), []).append(
                    (e["ts"], _end(e), e))
            elif cat in LAUNCH_CATS and "correlation" in args:
                self.launches[args["correlation"]] = (_thread(e), e["ts"])
                ext[args["correlation"]] = args.get("External id")
            elif cat in DEVICE_CATS:
                self.device.append(e)
        for corr, x in ext.items():
            if x in made_in:
                self.launches[corr] = (made_in[x], self.launches[corr][1])
        stretch = [h for h in self.harness if h[2] == "stretch"]
        if not stretch:
            raise RuntimeError("the trace holds no perfbench.stretch span")
        self.lo, self.hi, _, self.trainer = stretch[0]
        self.harness = [h for h in self.harness if h[2] != "stretch"]

    def steps(self) -> int:
        """The harness's step spans that start inside the stretch."""
        return sum(1 for a, _, n, _ in self.harness
                   if n == "step" and self.lo <= a <= self.hi)

    def _forward_sites(self):
        """-> ({(thread, seq) or seq: [(ts, site)] of the forward ops, by
        time}, {`Fwd thread id`: the thread it stands for})."""
        fwd: dict = {}
        for th, ops in self.ops.items():
            pts = [(a, id(e)) for a, _, e in ops if not _is_backward(e)]
            site = innermost(self.spans.get(th, []), pts)
            for a, _, e in ops:
                if not _is_backward(e):
                    seq = e["args"]["Sequence number"]
                    at = site[id(e)] and site[id(e)][2]
                    fwd.setdefault((th, seq), []).append((a, at))
                    fwd.setdefault(seq, []).append((a, at))
        for v in fwd.values():
            v.sort(key=lambda x: x[0])
        # the thread that each backward's `Fwd thread id` stands for: the
        # one whose forward ops hold the most of its sequence numbers
        votes: dict = {}
        threads = {k[0] for k in fwd if isinstance(k, tuple)}
        for ops in self.ops.values():
            for _, _, e in ops:
                if _is_backward(e):
                    args = e["args"]
                    f = args.get("Fwd thread id")
                    for th in threads:
                        if (th, args["Sequence number"]) in fwd:
                            k = votes.setdefault(f, {})
                            k[th] = k.get(th, 0) + 1
        owner = {f: max(k, key=k.get) for f, k in votes.items()}
        return fwd, owner

    def _backward_site(self, fwd, owner, e):
        seq = e["args"]["Sequence number"]
        th = owner.get(e["args"].get("Fwd thread id"))
        cands = fwd.get((th, seq)) or fwd.get(seq, [])
        before = [site for a, site in cands if a <= e["ts"]]
        return before[-1] if before else None

    def launch_sites(self) -> dict:
        """{correlation: (site, rule)}, rule 1, 2 or 3 as the module
        docstring numbers them."""
        out = {}
        by_thread: dict = {}
        for corr, (th, ts) in self.launches.items():
            by_thread.setdefault(th, []).append((ts, corr))
        fwd = owner = None
        for th, pts in by_thread.items():
            span_at = innermost(self.spans.get(th, []), pts)
            bwd_at = innermost([op for op in self.ops.get(th, [])
                                if _is_backward(op[2])], pts)
            for ts, corr in pts:
                sp, bw = span_at[corr], bwd_at[corr]
                site = None
                if bw is not None and (sp is None or bw[0] > sp[0]):
                    if fwd is None:
                        fwd, owner = self._forward_sites()
                    site = self._backward_site(fwd, owner, bw[2])
                if site is not None:
                    out[corr] = (site, 2)
                elif sp is not None:
                    out[corr] = (sp[2], 1)
                else:
                    out[corr] = (NONE, 3)
        return out

    def regions(self) -> tuple:
        """-> ({site: device seconds in the stretch}, {site: {kernel short
        name: seconds}}, {rule: device events})."""
        from perfbench.tracing import short_name
        sites = self.launch_sites()
        secs, kernels, rules = {}, {}, {1: 0, 2: 0, 3: 0}
        for e in self.device:
            if e["ts"] >= self.hi or _end(e) <= self.lo:
                continue
            site, rule = sites.get(e.get("args", {}).get("correlation"),
                                   (NONE, 3))
            d = (min(_end(e), self.hi) - max(e["ts"], self.lo)) * 1e-6
            secs[site] = secs.get(site, 0.0) + d
            k = kernels.setdefault(site, {})
            n = short_name(e["name"])
            k[n] = k.get(n, 0.0) + d
            rules[rule] += 1
        return secs, kernels, rules

    def gaps(self, n: int = 10) -> list:
        """The `n` largest idle gaps of the stretch: [[name, seconds,
        [the innermost program span of each other thread at the gap's
        midpoint]]], largest first."""
        from perfbench.tracing import clip, union
        busy = union(clip([(e["ts"], _end(e)) for e in self.device],
                          self.lo, self.hi))
        out, prev = [], self.lo
        for a, b in busy + [(self.hi, self.hi)]:
            if a > prev:
                mid = 0.5 * (prev + a)
                out.append([self._gap_name(mid), (a - prev) * 1e-6,
                            self._others_at(mid)])
            prev = max(prev, b)
        out.sort(key=lambda g: -g[1])
        return out[:n]

    def _gap_name(self, mid) -> str:
        inside = [h for h in self.harness if h[0] <= mid <= h[1]]
        name = min(inside, key=lambda s: s[1] - s[0])[2] if inside \
            else "between spans"
        mine = [s for s in self.spans.get(self.trainer, [])
                if s[0] <= mid <= s[1]]
        if mine:
            name += "/" + min(mine, key=lambda s: s[1] - s[0])[2]
        return name

    def _others_at(self, mid) -> list:
        out = []
        for th, spans in sorted(self.spans.items(), key=lambda x: str(x[0])):
            if th == self.trainer:
                continue
            inside = [s for s in spans if s[0] <= mid <= s[1]]
            if inside:
                out.append(min(inside, key=lambda s: s[1] - s[0])[2])
        return out


def summarize(events: list) -> dict:
    """Chrome trace events -> `regions` ({site: device seconds}, `(none)`
    included), `region_kernels`, `rules` (device events by rule),
    `steps` (the stretch's step spans), `idle_gaps` ([name, seconds], the
    10 largest) and `gap_threads` (the other threads' spans at each)."""
    t = Trace(events)
    secs, kernels, rules = t.regions()
    gaps = t.gaps()
    return {"regions": secs, "region_kernels": kernels, "rules": rules,
            "steps": t.steps(), "idle_gaps": [g[:2] for g in gaps],
            "gap_threads": [g[2] for g in gaps]}


def figures(s: dict) -> dict:
    """The five per-layer figures: each site's device ms a step."""
    n = s["steps"]
    return {k: 1e3 * s["regions"].get(site, 0.0) / n
            for k, site in FIGURES.items()} if n else {}


def report(s: dict, busy_s: float, log=None) -> None:
    log = log or sys.stderr
    n = max(s["steps"], 1)
    ms = sorted(((1e3 * v / n, k) for k, v in s["regions"].items()),
                reverse=True)
    total = sum(s["regions"].values())
    none = 100 * s["regions"].get(NONE, 0.0) / busy_s if busy_s else 0.0
    print(f"[regions] device ms a step over {s['steps']} steps: "
          + ", ".join(f"{k} {v:.3f}" for v, k in ms)
          + f"; sum {1e3 * total / n:.3f} of busy {1e3 * busy_s / n:.3f}; "
          f"(none) {none:.3f} % of busy; device events by rule "
          f"{s['rules']}", file=log)
    print("[sites] " + " ".join(f"{k}={v!r}" for k, v in figures(s).items()),
          file=log)
    for v, k in ms:
        top = sorted(s["region_kernels"][k].items(), key=lambda x: -x[1])[:4]
        print(f"[site-kernels] {k}: " + ", ".join(
            f"{name} {1e3 * sec / n:.3f}" for name, sec in top), file=log)
    print("[gaps] " + "; ".join(
        f"{name} {1e3 * sec:.3f} ms (other threads: "
        f"{', '.join(o) or 'none'})" for (name, sec), o in
        zip(s["idle_gaps"], s["gap_threads"])), file=log)


def tracer_class():
    """`tracing.Tracer` with a profiler over every thread (where torch
    offers it) and a `read` that adds the site split to the record."""
    from perfbench import tracing

    class SiteTracer(tracing.Tracer):
        all_threads = False

        def start(self, launch_counts):
            import torch
            torch.cuda.synchronize()
            act = torch.profiler.ProfilerActivity
            kw = {}
            try:
                kw["experimental_config"] = \
                    torch._C._profiler._ExperimentalConfig(
                        profile_all_threads=True)
                self.all_threads = True
            except (TypeError, AttributeError):
                pass
            self.prof = torch.profiler.profile(
                activities=[act.CPU, act.CUDA], **kw)
            self.prof.start()
            self.launches = launch_counts()
            self.outer = torch.profiler.record_function(
                tracing.PREFIX + "stretch")
            self.outer.__enter__()

        def read(self):
            if self.done is None:
                raise RuntimeError("the window ended before the traced "
                                   "stretch began")
            self.done.export_chrome_trace(self.path)
            self.done = None
            try:
                with open(self.path) as f:
                    events = json.load(f)["traceEvents"]
            finally:
                os.remove(self.path)
            self.record = tracing.summarize(events)
            self.record["launches"] = self.launches
            s = summarize(events)
            print(f"[profiler] every thread: {self.all_threads}",
                  file=sys.stderr)
            report(s, self.record["busy_s"])
            self.record["idle_gaps"] = s["idle_gaps"]
            self.record["regions"] = s["regions"]

    return SiteTracer


def main(argv=None) -> int:
    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from perfbench import run
    run.setup_environment()
    from perfbench import harness
    harness.Tracer = tracer_class()
    argv = list(sys.argv[1:] if argv is None else argv)
    return run.main(argv + ["--trace", "1"])


if __name__ == "__main__":
    raise SystemExit(main())
