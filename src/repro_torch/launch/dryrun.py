"""Multi-pod dry-run: trace every (arch x input-shape) step as the sharded
program one chip of the production mesh runs, with no device and no
memory, and extract the roofline terms.

The counterpart of `repro/launch/dryrun.py`. Where the reference lowers
and compiles an SPMD program for 256 (or 512) placeholder CPU devices
and reads XLA's cost and memory analyses, this builds the state as
DTensors on a `DeviceMesh` of that shape over a fake process group
(`launch.mesh`), each rank's shard a FakeTensor (shapes, no data), and
runs the port's own step on it: the train step (loss, gradients, AdamW),
`logits_fn` (prefill) or `decode_step` on an `init_cache` cache
(decode). DTensor partitions every op; a dispatch mode below it
(`_Accounting`) sees the ops of rank 0's shard and counts, per chip:

  * FLOPs, by torch's FLOP formulas (`torch.utils.flop_counter`), the
    kernels' custom ops by theirs (the band pairs and chunk products
    their bounds count);
  * bytes accessed: each non-view op's tensor inputs and outputs, the
    traffic of the port's eager (unfused) execution;
  * collective bytes, by kind: the result bytes of every collective
    DTensor's redistributions issue;
  * memory: the arguments' local bytes, and the high-water mark of live
    bytes (arguments, every allocation until it is freed, the kernels'
    workspace while they run).

The partitioner is DTensor's, not GSPMD's, so FLOPs and collectives need
not equal XLA's; argument bytes are set by the shardings alone and do.
Every number is a prediction against the H100's spec-sheet peaks
(`launch.mesh`), not a measurement.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import math
import sys
import time
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, get_config,
                                 shape_supported)
from repro_torch.core.treebytes import (leaf_arrays, torch_dtype,
                                        tree_unflatten)
from repro_torch.data.pipeline import batch_shapes
from repro_torch.dist import shardings as SH
from repro_torch.dist.api import axis_sizes, use_mesh
from repro_torch.launch.mesh import (HBM_BW, ICI_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.models import model as M
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.steps import apply_step, init_train_state

# the kernel modules by full name (the package exports functions of the
# same names)
SS = importlib.import_module("repro_torch.kernels.ssd_scan")
SW = importlib.import_module("repro_torch.kernels.swa_attention")

# functional collectives DTensor issues -> the reference's HLO op names
_COLL_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "all_to_all": "all-to-all",
    "broadcast": "collective-permute", "permute_tensor": "collective-permute",
}


class SkipPair(Exception):
    pass


class NotPorted(Exception):
    """A family the port does not run yet (`models.model.check_supported`)."""


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# ops that move no data: allocations and metadata-only views
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "_unsafe_view", "detach", "alias",
               "lift_fresh"}


def _written(func) -> tuple:
    """The positions and names of the arguments `func` writes in place."""
    got = getattr(func, "_repro_written", None)
    if got is None:
        got = tuple((i, a.name) for i, a in enumerate(func._schema.arguments)
                    if a.alias_info is not None and a.alias_info.is_write)
        func._repro_written = got
    return got


def _unwritten(args, kwargs, written):
    pos = {i for i, _ in written}
    names = {n for _, n in written}
    return [a for i, a in enumerate(args) if i not in pos] + \
        [v for k, v in kwargs.items() if k not in names]


def _workspace(func, args) -> int:
    """Bytes a kernel's custom op allocates beyond its outputs."""
    ops = torch.ops.repro_torch
    if func is ops.swa_flash_fwd.default:
        return SW.workspace_bytes(args[0], args[1], args[3], args[4], False)
    if func is ops.swa_flash_bwd.default:
        return SW.workspace_bytes(args[1], args[2], args[6], args[7], True)
    if func is ops.ssd_scan_fwd.default:
        return SS.workspace_bytes(args[0], args[2], args[5], False)
    if func is ops.ssd_scan_bwd.default:
        return SS.workspace_bytes(args[2], args[4], args[7], True)
    return 0


class _Accounting(TorchDispatchMode):
    """Per-chip counters over the ops of this rank's shards. An op on
    DTensors is passed on (NotImplemented) to DTensor, which runs it
    as ops on the local shards, which this mode then sees. The ops
    DTensor runs to infer a result's global shape are not counted
    (`paused`, `_quiet_shape_inference`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = {}
        self.live = 0
        self.peak = 0
        self.paused = 0
        self.shape_inferences = 0      # entries into the paused path
        self._alive = {}

    def track(self, t) -> None:
        """Count `t`'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._alive:
            return
        n = st.nbytes()

        def gone(_ref, key=key, n=n):
            self._alive.pop(key, None)
            self.live -= n

        self._alive[key] = weakref.ref(st, gone)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        ins = [a for a in flat if isinstance(a, torch.Tensor)]
        pkt = func._overloadpacket
        if pkt in flop_registry:
            self.flops += flop_registry[pkt](*args, **kwargs,
                                             out_val=out)
        ns = getattr(func, "namespace", "")
        if ns == "_c10d_functional" or ns == "c10d_functional":
            kind = _COLL_KIND.get(func.__name__.split(".")[0])
            if kind is not None:
                self.collectives[kind] = (self.collectives.get(kind, 0)
                                          + sum(map(_nbytes, outs)))
        elif not (func.is_view or ns == "prim"
                  or func.__name__.split(".")[0] in _NO_TRAFFIC):
            written = _written(func)
            if written:       # in place: the sources read, as much written
                self.bytes_accessed += 2 * sum(
                    _nbytes(a) for a in _unwritten(args, kwargs, written)
                    if isinstance(a, torch.Tensor))
            else:
                self.bytes_accessed += sum(map(_nbytes, ins)) \
                    + sum(map(_nbytes, outs))
        extra = _workspace(func, args) if ns == "repro_torch" else 0
        # outputs on a storage already live (views) allocate nothing
        fresh = [o for o in outs if id(o.untyped_storage()) not in self._alive]
        self.peak = max(self.peak, self.live + extra
                        + sum(_nbytes(o) for o in fresh))
        for o in outs:
            self.track(o)
        return out


@contextlib.contextmanager
def _quiet_shape_inference(acct):
    """DTensor infers each op's global output shape by running the op on
    global-shaped fake tensors; pause the counters while it does. The
    hook is a private torch method (`ShardingPropagator.
    _propagate_tensor_meta_non_cached`, on torch 2.11 and 2.13);
    `tests/test_torch_dryrun.py` fails if it is gone or no longer
    entered."""
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def paused(self, op_schema):
        acct.paused += 1
        acct.shape_inferences += 1
        try:
            return orig(self, op_schema)
        finally:
            acct.paused -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = paused
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _local_shape(shape, ns) -> tuple:
    sizes = axis_sizes(ns.mesh)
    local = list(shape)
    for md, p in enumerate(ns.placements):
        if p.is_shard():
            local[p.dim] //= sizes[md]
    return tuple(local)


def _as_dtensors(tree, shardings):
    """Each global fake leaf -> a DTensor whose rank-0 shard is a fresh
    fake tensor of the local shape (the global leaf's storage is never
    referenced)."""
    out = []
    for t, ns in zip(leaf_arrays(tree), leaf_arrays(shardings)):
        local = torch.empty(_local_shape(t.shape, ns), dtype=t.dtype)
        out.append(DTensor.from_local(local, ns.mesh, ns.placements,
                                      run_check=False, shape=t.shape,
                                      stride=t.stride()))
    return tree_unflatten(tree, out)


@dataclasses.dataclass
class Compiled:
    """What a traced run counted (per chip)."""
    flops: float
    bytes_accessed: float
    collectives: dict
    memory: dict

    def cost_analysis(self) -> dict:
        return {"flops": self.flops, "bytes accessed": self.bytes_accessed}


class Lowered:
    """The sharded fake program of one (arch, shape) pair on a mesh: its
    DTensor arguments and the step to run on them. `compile()` runs it
    under the counters."""

    def __init__(self, step, args, mesh):
        self.step, self.args, self.mesh = step, args, mesh

    def compile(self) -> Compiled:
        acct = _Accounting()
        for t in leaf_arrays(self.args):
            acct.track(t.to_local())
        args_bytes = acct.live
        # the fake mode is not entered: the shards are FakeTensors, which
        # carry it into every op on them, while DTensor's own index
        # arithmetic (a strided shard's offsets) needs real tensors; the
        # step's few factory calls (positions, masks) make small real ones
        with _quiet_shape_inference(acct), acct, use_mesh(self.mesh), \
                implicit_replication():
            out = self.step(*self.args)
        outs = [o for o in leaf_arrays(out) if hasattr(o, "to_local")]
        out_bytes = sum(_nbytes(o.to_local()) for o in outs)
        memory = {"argument_bytes": args_bytes, "output_bytes": out_bytes,
                  "temp_bytes": acct.peak - args_bytes,
                  "peak_bytes": acct.peak}
        return Compiled(float(acct.flops), float(acct.bytes_accessed),
                        dict(acct.collectives), memory)


def _abstract(cfg, shape):
    """Global fake leaves of the pair's inputs (no data, no memory)."""
    if shape.kind == "train":
        return init_train_state(cfg, 0, device="cpu")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return params


def _batch(cfg, shape):
    return {k: torch.zeros(s, dtype=torch_dtype(d))
            for k, (s, d) in batch_shapes(cfg, shape).items()}


def _eager(fn):
    """A serving function without its `torch.inference_mode()` (DTensor's
    views cannot run on inference tensors); the dry-run calls it under
    `torch.no_grad()`, which allocates the same."""
    return getattr(fn, "__wrapped__", fn)


def check_ported(cfg) -> None:
    try:
        M.check_supported(cfg)
    except NotImplementedError as e:
        raise NotPorted(str(e)) from None


def triage(cfg, shape) -> None:
    """Raise `NotPorted` for a family the port lacks, then `SkipPair` for
    a pair the reference skips too (`shape_supported`); return for a
    pair to trace."""
    check_ported(cfg)
    ok, why = shape_supported(cfg, shape)
    if not ok:
        raise SkipPair(why)


def build_lowered(arch: str, shape_name: str, mesh, verbose=False,
                  cfg=None):
    """Returns (lowered, meta) for the (arch, shape) pair on `mesh`. The
    port's layer loop is a python loop, so every layer is counted (the
    reference's `unroll=True`; the record says so)."""
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    triage(cfg, shape)

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake, use_mesh(mesh):
        if shape.kind == "decode":
            params = _abstract(cfg, shape)
            cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 "cpu")
            tokens = {"t": torch.zeros((shape.global_batch, 1),
                                       dtype=torch.int32)}
            p = _as_dtensors(params, SH.named(SH.param_specs(cfg, params),
                                              params, mesh))
            c = _as_dtensors(cache, SH.named(
                SH.cache_specs(cfg, cache, shape.global_batch, mesh),
                cache, mesh))
            t = _as_dtensors(tokens, SH.named(SH.batch_specs(cfg, tokens),
                                              tokens, mesh))["t"]

            def step(params, cache, tokens):
                with torch.no_grad():
                    return _eager(M.decode_step)(cfg, params, cache, tokens)

            args = (p, c, t)
            tokens_per_step = shape.global_batch
            train = False
        elif shape.kind == "prefill":
            params = _abstract(cfg, shape)
            # the prefill's inputs: tokens, and a VLM's patches (the
            # labels are no argument of logits_fn)
            batch = {k: v for k, v in _batch(cfg, shape).items()
                     if k != "labels"}
            p = _as_dtensors(params, SH.named(SH.param_specs(cfg, params),
                                              params, mesh))
            b = _as_dtensors(batch, SH.named(SH.batch_specs(cfg, batch),
                                             batch, mesh))

            def step(params, batch):
                with torch.no_grad():
                    return _eager(M.logits_fn)(cfg, params, batch)

            args = (p, b)
            tokens_per_step = shape.global_batch * shape.seq_len
            train = False
        else:
            state = _abstract(cfg, shape)
            batch = _batch(cfg, shape)
            s = _as_dtensors(state, SH.named(SH.state_specs(cfg, state),
                                             state, mesh))
            b = _as_dtensors(batch, SH.named(SH.batch_specs(cfg, batch),
                                             batch, mesh))
            opt = AdamConfig()

            def step(state, batch):
                new_params, new_opt, metrics = apply_step(cfg, opt, state,
                                                          batch)
                return ({"params": new_params, "opt_state": new_opt,
                         "step": state["step"] + 1, "rng": state["rng"]},
                        metrics)

            args = (s, b)
            tokens_per_step = shape.global_batch * shape.seq_len
            train = True
    meta = {"arch": arch, "shape": shape_name, "unroll": True,
            "tokens_per_step": tokens_per_step, "train": train,
            "chips": math.prod(axis_sizes(mesh)),
            "mesh": "x".join(map(str, axis_sizes(mesh)))}
    return Lowered(step, args, mesh), meta


def analyse(lowered, compiled, meta, cfg) -> dict:
    """Roofline terms. The counters saw rank 0's shards, so FLOPs, bytes
    and collective bytes are per chip; the terms divide by per-chip
    peaks."""
    chips = meta["chips"]
    cost = compiled.cost_analysis()
    flops = float(cost.get("flops", 0.0))          # per chip
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    coll = dict(compiled.collectives)
    coll["total"] = sum(coll.values())

    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = bytes_acc / HBM_BW
    t_coll = coll["total"] / ICI_BW
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]

    n_active = cfg.active_param_count()
    mult = 6 if meta["train"] else 2
    model_flops = mult * n_active * meta["tokens_per_step"]   # global

    return {
        **meta,
        "hlo_flops_per_chip": flops,
        "hlo_flops_global": flops * chips,
        "hlo_bytes_per_chip": bytes_acc,
        "collective_bytes": coll,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": model_flops,
        "useful_compute_ratio": (model_flops / (flops * chips))
        if flops else None,
        "params_total": cfg.param_count(),
        "params_active": n_active,
        "memory": dict(compiled.memory),
    }


def run_pair(arch: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True, cfg=None, mesh=None) -> dict:
    cfg = cfg or get_config(arch)
    mesh = mesh if mesh is not None else \
        make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    lowered, meta = build_lowered(arch, shape_name, mesh, cfg=cfg)
    t1 = time.time()
    compiled = lowered.compile()
    t2 = time.time()
    rec = analyse(lowered, compiled, meta, cfg)
    rec["lower_s"] = round(t1 - t0, 2)
    rec["compile_s"] = round(t2 - t1, 2)
    if verbose:
        mem = rec.get("memory", {})
        print(f"[ok] {arch} x {shape_name} mesh={rec['mesh']} "
              f"flops/chip={rec['hlo_flops_per_chip']:.3e} "
              f"bytes/chip={rec['hlo_bytes_per_chip']:.3e} "
              f"coll/chip={rec['collective_bytes']['total']:.3e} "
              f"dom={rec['dominant']} "
              f"useful={rec['useful_compute_ratio'] and round(rec['useful_compute_ratio'],3)} "
              f"args/chip={mem.get('argument_bytes', 0)/2**30:.2f}GiB "
              f"peak/chip={mem.get('peak_bytes', 0)/2**30:.2f}GiB "
              f"(build {rec['lower_s']}s, trace {rec['compile_s']}s)",
              flush=True)
    return rec


def extrapolation_period(cfg) -> int:
    """Smallest layer count that tiles the full model exactly (hybrid
    period x local:global interleave), as the reference's."""
    period, _ = M._stack_period(cfg)
    if cfg.global_every:
        period = math.lcm(period, cfg.global_every)
    return period


_SCALARS = ("hlo_flops_per_chip", "hlo_bytes_per_chip", "t_compute_s",
            "t_memory_s", "t_collective_s")


def run_pair_roofline(arch: str, shape_name: str, *, multi_pod: bool = False,
                      cfg=None, verbose: bool = True, mesh=None) -> dict:
    """Roofline terms via layer extrapolation: trace at L=P and L=2P layers
    (P = pattern period) and extrapolate linearly, as the reference does
    (exact: the layers are periodic and the counts add up layer by
    layer)."""
    cfg = cfg or get_config(arch)
    P_ = extrapolation_period(cfg)
    L = cfg.num_layers
    if L <= 2 * P_:
        rec = run_pair(arch, shape_name, multi_pod=multi_pod, cfg=cfg,
                       verbose=verbose, mesh=mesh)
        rec["extrapolated"] = False
        return rec
    c1 = dataclasses.replace(cfg, name=cfg.name, num_layers=P_)
    c2 = dataclasses.replace(cfg, name=cfg.name, num_layers=2 * P_)
    r1 = run_pair(arch, shape_name, multi_pod=multi_pod, cfg=c1,
                  verbose=False, mesh=mesh)
    r2 = run_pair(arch, shape_name, multi_pod=multi_pod, cfg=c2,
                  verbose=False, mesh=mesh)

    def ex(v1, v2):
        return v1 + (v2 - v1) * (L - P_) / P_

    rec = dict(r2)
    for k in _SCALARS:
        rec[k] = ex(r1[k], r2[k])
    coll = {k: ex(r1["collective_bytes"].get(k, 0),
                  r2["collective_bytes"].get(k, 0))
            for k in set(r1["collective_bytes"]) | set(r2["collective_bytes"])}
    rec["collective_bytes"] = coll
    rec["t_collective_s"] = coll["total"] / ICI_BW
    rec["hlo_flops_global"] = rec["hlo_flops_per_chip"] * rec["chips"]
    rec["dominant"] = max(
        (("compute", rec["t_compute_s"]), ("memory", rec["t_memory_s"]),
         ("collective", rec["t_collective_s"])), key=lambda kv: kv[1])[0]
    rec["params_total"] = cfg.param_count()
    rec["params_active"] = cfg.active_param_count()
    mult = 6 if rec["train"] else 2
    rec["model_flops"] = mult * rec["params_active"] * rec["tokens_per_step"]
    rec["useful_compute_ratio"] = (rec["model_flops"]
                                   / rec["hlo_flops_global"])
    rec["extrapolated"] = True
    rec["memory"] = {}            # memory comes from the full-depth trace
    rec["lower_s"] = r1["lower_s"] + r2["lower_s"]
    rec["compile_s"] = r1["compile_s"] + r2["compile_s"]
    if verbose:
        print(f"[ok] {arch} x {shape_name} mesh={rec['mesh']} (extrap {P_}->"
              f"{L}L) flops/chip={rec['hlo_flops_per_chip']:.3e} "
              f"bytes/chip={rec['hlo_bytes_per_chip']:.3e} "
              f"coll/chip={coll['total']:.3e} dom={rec['dominant']} "
              f"useful={round(rec['useful_compute_ratio'], 3)}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default=None, help="append JSONL records here")
    ap.add_argument("--mode", choices=["proof", "roofline"], default="proof",
                    help="roofline = layer-extrapolated analysis")
    args = ap.parse_args(argv)

    pairs = []
    if args.all:
        for a in ASSIGNED_ARCHS:
            for s in INPUT_SHAPES:
                pairs.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        pairs = [(args.arch, args.shape)]

    records = []
    failures = 0
    for a, s in pairs:
        try:
            if args.mode == "roofline":
                rec = run_pair_roofline(a, s, multi_pod=args.multi_pod)
            else:
                rec = run_pair(a, s, multi_pod=args.multi_pod)
            records.append(rec)
        except NotPorted as e:
            print(f"[not ported] {a} x {s}: {e}", flush=True)
            records.append({"arch": a, "shape": s, "not_ported": str(e)})
        except SkipPair as e:
            print(f"[skip] {a} x {s}: {e}", flush=True)
            records.append({"arch": a, "shape": s, "skipped": str(e)})
        except Exception as e:
            failures += 1
            print(f"[FAIL] {a} x {s}: {type(e).__name__}: {e}", flush=True)
            records.append({"arch": a, "shape": s, "error": repr(e)})
        if args.json:
            with open(args.json, "a") as f:
                f.write(json.dumps(records[-1]) + "\n")
    print(f"done: {len(records)} pairs, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
