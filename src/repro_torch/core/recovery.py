"""Recovery paths (paper §3 step 5, §4.2 "Loading", §4.3 decoding).

Three tiers, tried in order:
  1. software failure (trainer died, SMPs alive): reassemble the state
     from every SG member's in-memory shard;
  2. single node failure per SG: RAIM5-decode the dead node's blocks from
     survivors' shards + parities, then reassemble;
  3. >1 node failure in an SG: fall back to the last persisted REFT-Ckpt.

This module is the *tier policy*; the data movement lives in
`repro_torch.core.loader`: every tier routes through a `LoadPlan` executed with
parallel ranged reads (shared-memory segments for tiers 1-2, seek+read
over `.reft` files for tier 3), range-limited RAIM5 decode, incremental
CRC folded into the read pass, and streamed per-leaf assembly.  Tier 3
additionally supports reshard-on-restore: a family saved by an n-member
SG restores under an m-member group (elastic n->m restart) because the
saved layout is rediscovered from the file heads.
"""
from __future__ import annotations

import glob
import os
import pickle
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.loader import (
    CHUNK_BYTES, ChainSource, CrcMismatch, DeltaLayer, FileSource, LoadStats,
    ShmSource, build_plan, load_bytes, load_tree, probe_crc, stream_crc,
)
from repro_torch.core.readsched import SourceLost
from repro_torch.core.smp import ReadOnlyNode
from repro_torch.core.treebytes import FlatSpec

CRC_CHUNK_BYTES = CHUNK_BYTES       # one streaming granularity everywhere


class RecoveryError(RuntimeError):
    pass


def attach_survivors(run: str, nodes: List[int], n: int, total_bytes: int
                     ) -> Dict[int, ReadOnlyNode]:
    views = {}
    for node in nodes:
        try:
            views[node] = ReadOnlyNode(run, node, n, total_bytes)
        except (FileNotFoundError, RuntimeError):
            pass
    return views


def common_step(views: Dict[int, ReadOnlyNode]) -> Optional[int]:
    """Newest step CLEAN on *every* surviving view."""
    sets = [set(v.clean_steps()) for v in views.values()]
    if not sets:
        return None
    common = set.intersection(*sets)
    return max(common) if common else None


def verify_crc(view: ReadOnlyNode, step: int, n: int, total_bytes: int,
               chunk_bytes: int = CRC_CHUNK_BYTES) -> bool:
    """Standalone integrity probe: recompute the snapshot's own-shard
    checksum (written at save time) in fixed-size streamed chunks — never
    holds more than `chunk_bytes`, so probing a large member does not
    spike RSS.  The recovery ladder itself no longer calls this (its
    checks are folded into the loader's read pass / `loader.probe_crc`);
    it remains the public health-check utility for scrubbers and tests,
    with identical verdict semantics (unreadable meta = corrupt)."""
    try:
        meta = pickle.loads(view.meta(step))
    except Exception:
        return False
    expect = meta.get("crc_own")
    if expect is None:                       # legacy snapshot: no checksum
        return True
    # the engine streams the own region contiguously (full blocks incl.
    # the zero padding of the tail block), so one pass over it suffices
    span = total_bytes if n == 1 else view.layout.own_bytes
    try:
        crc = stream_crc(lambda lo, hi: view.read_range(step, lo, hi),
                         span, chunk_bytes)
    except Exception:
        return False
    return crc == expect


def restore_bytes(views: Dict[int, ReadOnlyNode], n: int, total_bytes: int,
                  step: int, failed: Optional[int] = None,
                  need: Optional[Sequence[Tuple[int, int]]] = None,
                  stats: Optional[LoadStats] = None,
                  sched=None) -> np.ndarray:
    """State bytes at `step` via the ranged loader; RAIM5-decodes exactly
    the plan-intersecting sub-ranges of `failed` if set.  With `need`,
    bytes outside the requested ranges stay zero."""
    plan = build_plan(n, total_bytes, need=need, failed=failed)
    buf, _ = load_bytes(plan, ShmSource(views, step), verify=False,
                        stats=stats, sched=sched)
    return buf


def _load_with_demotion(n: int, total_bytes: int, template: Any,
                        spec: FlatSpec, source_of, holders: List[int],
                        absent: List[int],
                        need: Optional[Sequence[Tuple[int, int]]],
                        device_put: bool, stats: LoadStats,
                        sched=None) -> Tuple[Any, List[int], List[int]]:
    """Execute the plan for one candidate step, folding each fully-read
    member's CRC into its read pass (full plans) or streaming a probe of
    the members the plan reads first (partial plans — `crc_own` is a
    whole-region digest); either way a mismatch demotes that member to
    failed and re-plans (RAIM5's one-member budget permitting).

    `source_of(usable)` builds the range source over the given members.
    Returns (tree, usable, corrupt); raises `RecoveryError` when the
    demotions exceed the parity budget.  The adaptive scheduler's
    `SourceLost` (a member died mid-read and its chunks could not be
    cleanly rerouted to parity) demotes exactly like a digest mismatch —
    this loop is the ladder's mid-flight re-plan acceptance."""
    corrupt: List[int] = []
    probed_ok: set = set()
    while True:
        usable = [nd for nd in holders if nd not in corrupt]
        missing = sorted(set(range(n)) - set(usable))
        if not usable or len(missing) > 1:
            raise RecoveryError(
                f"member demotions exceed RAIM5 budget (absent: {absent}, "
                f"corrupt: {corrupt})")
        failed = missing[0] if missing else None
        plan = build_plan(n, total_bytes, need=need, failed=failed)
        src = source_of(usable)
        if need is not None:
            # only members verified against the WHOLE-region digest may be
            # skipped on a demotion retry: a stripe-digest probe covered
            # exactly the current plan's segments, and the re-plan's
            # decode may touch new ones (re-probing those is cheap — that
            # is the point of the table)
            bad = probe_crc(plan, src, stats=stats, skip=probed_ok,
                            full_verified=probed_ok)
            if bad:
                corrupt.extend(bad)
                continue
            try:
                tree, _ = load_tree(plan, src, template, spec,
                                    verify=False, device_put=device_put,
                                    stats=stats, sched=sched)
                return tree, usable, corrupt
            except SourceLost as e:
                corrupt.append(e.node)
                continue
        try:
            tree, _ = load_tree(plan, src, template, spec, verify=True,
                                device_put=device_put, stats=stats,
                                sched=sched)
            return tree, usable, corrupt
        except (CrcMismatch, SourceLost) as e:
            corrupt.append(e.node)


def restore_state(run: str, n: int, total_bytes: int, template: Any,
                  alive_nodes: List[int],
                  info: Optional[dict] = None,
                  step: Optional[int] = None,
                  need: Optional[Sequence[Tuple[int, int]]] = None,
                  device_put: bool = False,
                  stats: Optional[LoadStats] = None,
                  sched=None) -> Tuple[Any, int, dict]:
    """End-to-end in-memory restore. Returns (state_tree, step, extra_meta).

    Raises RecoveryError when more than one node per SG is gone (tier 3
    must take over).  When `info` (a dict) is passed it is filled with
    what actually happened: {"attached", "clean" (each attached member's
    clean steps as read), "corrupt", "missing", "stale"} — callers
    derive the recovery tier from it instead of re-probing segments.
    `step` pins a specific snapshot step; `need` restricts the load to
    global byte ranges (partial / resharded restore); `stats` (a
    `LoadStats`) collects per-phase accounting."""
    st = stats if stats is not None else LoadStats()
    views = attach_survivors(run, alive_nodes, n, total_bytes)
    try:
        if info is not None:
            info["attached"] = sorted(views)
        # Newest usable step: clean on every member, or clean on all but
        # ONE — a member whose async round lagged behind (its buffers
        # rotated past the step) is byte-for-byte equivalent to a failed
        # node at that step, and RAIM5 decodes its shard from the others'
        # parity.  Corrupt members (CRC mismatch, folded into the loader's
        # read pass) are demoted the same way.
        clean = {node: set(v.clean_steps()) for node, v in views.items()}
        if info is not None:
            info["clean"] = {node: sorted(s) for node, s in clean.items()}
        candidates = sorted(set().union(*clean.values()), reverse=True) \
            if clean else []
        if step is not None:
            candidates = [s for s in candidates if s == step]
        chosen = None
        for cand in candidates:
            holders = [nd for nd, steps in clean.items() if cand in steps]
            if n - len(holders) > 1:
                continue
            absent = sorted(set(range(n)) - set(holders))
            try:
                tree, usable, corrupt = _load_with_demotion(
                    n, total_bytes, template,
                    _spec_of(views, holders, cand),
                    lambda members, c=cand: ShmSource(
                        {nd: views[nd] for nd in members}, c),
                    holders, absent, need, device_put, st, sched=sched)
            except RecoveryError:
                continue
            chosen = (cand, tree, usable, corrupt)
            break
        if chosen is None:
            raise RecoveryError(
                f"no usable snapshot step across survivors (dead: "
                f"{sorted(set(range(n)) - set(views))}, clean steps: "
                f"{ {nd: sorted(s) for nd, s in clean.items()} }); "
                f"RAIM5 protects exactly one member")
        cand, tree, usable, corrupt = chosen
        missing = sorted(set(range(n)) - set(usable))
        if info is not None:
            info["corrupt"] = corrupt
            info["missing"] = missing
            info["stale"] = [nd for nd in views
                             if nd not in usable and nd not in corrupt]
        extra = {}
        for nd in usable:              # usable members' metas parsed during
            try:                       # the load; loop is belt-and-braces
                extra = pickle.loads(views[nd].meta(cand)).get("extra", {})
                break
            except Exception:
                continue
        return tree, cand, extra
    finally:
        for v in views.values():
            v.close()


def _spec_of(views, holders, step) -> FlatSpec:
    """Spec from the first holder whose meta parses — a member with a
    corrupt meta must be DEMOTED by the loader (it is), not allowed to
    crash the ladder before the load even starts."""
    last: Optional[Exception] = None
    for nd in holders:
        try:
            meta = pickle.loads(views[nd].meta(step))
            return FlatSpec.from_json(meta["spec"])
        except Exception as e:
            last = e
    raise RecoveryError(
        f"no member meta parseable at step {step}: {last!r}")


# --------------------------------------------------------------- tier 3
_CKPT_RE = re.compile(r"^step-(\d+)-node-(\d+)\.reft$")
_DELTA_RE = re.compile(r"^step-(\d+)-from-(\d+)-node-(\d+)\.reftd$")


def checkpoint_families(ckpt_dir: str) -> Dict[int, set]:
    """{step: {nodes on disk}} from anchored-regex filename parsing (a
    future name with extra dashes can no longer corrupt the step/node
    split the way `split("-")` indexing did)."""
    families: Dict[int, set] = {}
    for p in glob.glob(os.path.join(ckpt_dir, "step-*-node-*.reft")):
        m = _CKPT_RE.match(os.path.basename(p))
        if not m:
            continue
        families.setdefault(int(m.group(1)), set()).add(int(m.group(2)))
    return families


def delta_families(ckpt_dir: str) -> Dict[int, Dict[int, set]]:
    """{step: {base_step: {nodes on disk}}} from `.reftd` filenames.  The
    base step rides in the NAME (`step-S-from-B-node-N.reftd`) so chain
    resolution and GC liveness never open a file."""
    fams: Dict[int, Dict[int, set]] = {}
    for p in glob.glob(os.path.join(ckpt_dir, "step-*-from-*-node-*.reftd")):
        m = _DELTA_RE.match(os.path.basename(p))
        if not m:
            continue
        step, base, node = (int(m.group(1)), int(m.group(2)),
                            int(m.group(3)))
        fams.setdefault(step, {}).setdefault(base, set()).add(node)
    return fams


def resolve_chain(ckpt_dir: str, step: int,
                  full: Optional[Dict[int, set]] = None,
                  deltas: Optional[Dict[int, Dict[int, set]]] = None
                  ) -> Optional[Tuple[int, List[Tuple[int, int]]]]:
    """Resolve `step` against the on-disk delta chains: returns
    `(keyframe_step, links)` with links `[(step, base_step), ...]`
    oldest -> newest ending at `step`, or None when no chain bottoms out
    at a full `.reft` family.  A full family at `step` itself resolves
    to `(step, [])`.  Cycles and dangling bases fall through to None."""
    if full is None:
        full = checkpoint_families(ckpt_dir)
    if deltas is None:
        deltas = delta_families(ckpt_dir)

    def walk(s: int, seen: frozenset
             ) -> Optional[Tuple[int, List[Tuple[int, int]]]]:
        if s in full:
            return s, []
        if s in seen or s not in deltas:
            return None
        for base in sorted(deltas[s], reverse=True):
            r = walk(base, seen | {s})
            if r is not None:
                kf, links = r
                return kf, links + [(s, base)]
        return None

    return walk(int(step), frozenset())


def _chain_complete(links: Sequence[Tuple[int, int]],
                    deltas: Dict[int, Dict[int, set]], n: int) -> bool:
    want = set(range(n))
    return all(deltas.get(s, {}).get(b, set()) & want == want
               for s, b in links)


def restorable_steps(ckpt_dir: str, n: Optional[int] = None) -> List[int]:
    """Sorted steps with a restorable on-disk family; with `n`, only
    COMPLETE ones (all n member shards).  A delta step counts when its
    whole chain — every `.reftd` link plus the keyframe it bottoms out
    at — is complete; a torn link poisons every dependent step."""
    families = checkpoint_families(ckpt_dir)
    deltas = delta_families(ckpt_dir)
    steps = [s for s, nodes in families.items()
             if n is None or nodes == set(range(n))]
    for s in deltas:
        if s in families:
            continue
        res = resolve_chain(ckpt_dir, s, families, deltas)
        if res is None:
            continue
        kf, links = res
        if n is None or (families.get(kf) == set(range(n))
                         and _chain_complete(links, deltas, n)):
            steps.append(s)
    return sorted(steps)


def latest_checkpoint_step(ckpt_dir: str,
                           n: Optional[int] = None) -> Optional[int]:
    """Newest persisted step; with `n`, newest COMPLETE (chain-
    resolvable) family — torn families are not restorable."""
    steps = restorable_steps(ckpt_dir, n)
    return max(steps) if steps else None


def _family_paths(ckpt_dir: str, step: int, nodes) -> Dict[int, str]:
    return {node: os.path.join(ckpt_dir, f"step-{step}-node-{node}.reft")
            for node in nodes}


def _open_family(ckpt_dir: str, step: int, nodes: set) -> FileSource:
    """Attach a family, validating completeness against its OWN saved
    layout (the heads record n) — an n-member family restores under any
    current group size (reshard-on-restore)."""
    if not nodes:
        raise RecoveryError(f"checkpoint family step {step} has no shards")
    # lightweight probe: one head read to learn the saved layout (the one
    # file re-opened by the full FileSource below)
    path = _family_paths(ckpt_dir, step, [min(nodes)])[min(nodes)]
    with open(path, "rb") as f:
        saved_n = pickle.load(f)["n"]
    want = set(range(saved_n))
    if nodes & want != want:
        missing = sorted(want - nodes)[0]
        raise RecoveryError(
            f"checkpoint family step {step} is torn: missing "
            f"step-{step}-node-{missing}.reft")
    return FileSource(_family_paths(ckpt_dir, step, sorted(want)))


def _delta_paths(ckpt_dir: str, step: int, base: int, nodes) -> Dict[int, str]:
    return {node: os.path.join(
        ckpt_dir, f"step-{step}-from-{base}-node-{node}.reftd")
        for node in nodes}


def _open_chain(ckpt_dir: str, step: int,
                full: Optional[Dict[int, set]] = None,
                deltas: Optional[Dict[int, Dict[int, set]]] = None):
    """Attach `step`, resolving a delta chain back to its keyframe when
    `step` has no full family of its own.  Returns a source with the
    standard interface (`FileSource` for a full family, `ChainSource`
    over `DeltaLayer`s otherwise); completeness of every link is checked
    against the keyframe's OWN saved layout, so an n-member chain
    restores under any current group size."""
    if full is None:
        full = checkpoint_families(ckpt_dir)
    if deltas is None:
        deltas = delta_families(ckpt_dir)
    if step in full:
        return _open_family(ckpt_dir, step, full[step])
    res = resolve_chain(ckpt_dir, step, full, deltas)
    if res is None:
        raise RecoveryError(
            f"no resolvable delta chain for step {step} in {ckpt_dir}")
    kf, links = res
    base = _open_family(ckpt_dir, kf, full[kf])
    layers: List[DeltaLayer] = []
    try:
        want = set(range(base.n))
        for s, b in links:
            have = deltas.get(s, {}).get(b, set())
            if have & want != want:
                missing = sorted(want - have)[0]
                raise RecoveryError(
                    f"delta family step {s} (base {b}) is torn: missing "
                    f"step-{s}-from-{b}-node-{missing}.reftd")
            layers.append(DeltaLayer.from_files(
                _delta_paths(ckpt_dir, s, b, sorted(want))))
        return ChainSource(base, layers)
    except BaseException:
        for ly in layers:
            ly.close()
        base.close()
        raise


def restore_from_checkpoint(ckpt_dir: str, n: int, template: Any,
                            step: Optional[int] = None,
                            need: Optional[Sequence[Tuple[int, int]]] = None,
                            device_put: bool = False,
                            stats: Optional[LoadStats] = None,
                            sched=None) -> Tuple[Any, int, dict]:
    """Rebuild from REFT-Ckpt files through the same `LoadPlan` executors
    as the in-memory tiers: per-member-parallel ranged file reads, CRC
    folded into the pass, RAIM5 demotion of a corrupt shard, and elastic
    reshard when the family was saved with a different SG size than `n`."""
    st = stats if stats is not None else LoadStats()
    if not st.target_n:       # the ladder presets target.sg_size; keep it
        st.target_n = n
    families = checkpoint_families(ckpt_dir)
    deltas = delta_families(ckpt_dir)
    resolvable = set(families) | {
        s for s in deltas
        if resolve_chain(ckpt_dir, s, families, deltas) is not None}
    if step is not None:
        if step not in resolvable:
            raise RecoveryError(f"no checkpoint for step {step} "
                                f"in {ckpt_dir}")
        candidates = [step]
    else:
        candidates = sorted(resolvable, reverse=True)
    last_err: Optional[Exception] = None
    for cand in candidates:
        try:
            src = _open_chain(ckpt_dir, cand, families, deltas)
        except (RecoveryError, FileNotFoundError, EOFError, KeyError,
                TypeError, pickle.UnpicklingError) as e:
            last_err = e                # malformed head = unusable family
            continue
        try:
            saved_n = src.n
            st.saved_n = saved_n
            st.resharded = bool(n) and saved_n != n
            meta = spec = None
            for nd in src.nodes:       # a member with a corrupt meta blob
                try:                   # is demoted by the loader — any
                    meta = src.meta(nd)            # parseable meta will do
                    spec = FlatSpec.from_json(meta["spec"])
                    break
                except Exception:
                    continue
            if spec is None:
                raise RecoveryError(
                    f"family step {src.step}: no member meta parseable")
            holders = list(src.nodes)
            tree, usable, corrupt = _load_with_demotion(
                saved_n, src.total_bytes, template, spec,
                lambda members: src, holders, [], need, device_put, st,
                sched=sched)
            return tree, src.step, meta.get("extra", {})
        except (RecoveryError, KeyError, TypeError, ValueError, EOFError,
                pickle.UnpicklingError) as e:
            last_err = e               # malformed family: try the next one
            continue
        finally:
            src.close()
    if step is not None and last_err is not None:
        raise RecoveryError(str(last_err))
    raise RecoveryError(
        f"no complete checkpoint available"
        + (f" ({last_err})" if last_err else ""))


# --------------------------------------------------------------- tier 4
def _open_remote_chain(store, prefix: str, step: int, retry=None):
    """Attach a remote family at `step`, following manifest `base_step`
    links back to a full keyframe family.  Returns `(src, holders)`:
    the chain (or plain) source plus the members whose shard objects all
    exist at EVERY link — a member missing any link of its chain cannot
    serve reads and is left to RAIM5 reconstruction."""
    from repro_torch.core.loader import ObjectSource
    from repro_torch.store.base import retrier
    from repro_torch.store.manifest import load_manifest, manifest_base_step

    wrap = retrier(retry)
    man = load_manifest(store, prefix, step, retry=retry)
    link_mans: List[dict] = []           # newest -> oldest delta manifests
    seen = {int(step)}
    while True:
        base = manifest_base_step(man)
        if base is None:
            break
        link_mans.append(man)
        if base in seen:
            raise RecoveryError(
                f"remote delta chain for step {step} cycles at {base}")
        seen.add(base)
        man = load_manifest(store, prefix, base, retry=retry)
    base_man = man
    src = ObjectSource(store, base_man, retry=wrap)
    if link_mans:
        src = ChainSource(src, [DeltaLayer.from_objects(store, m, retry=wrap)
                                for m in reversed(link_mans)])
    holders = []
    for nd in range(src.n):
        if all(nd in m["nodes"] and store.exists(m["nodes"][nd]["key"])
               for m in [base_man] + link_mans):
            holders.append(nd)
    return src, holders


def restore_from_objstore(store, prefix: str, n: int, template: Any,
                          step: Optional[int] = None,
                          need: Optional[Sequence[Tuple[int, int]]] = None,
                          device_put: bool = False,
                          stats: Optional[LoadStats] = None,
                          retry=None, sched=None) -> Tuple[Any, int, dict]:
    """Rebuild from a remote object-store family: the manifest names the
    shard objects and saved topology, `ObjectSource` turns `LoadPlan`
    ranges into positioned remote reads (no local staging copy), and the
    rest — folded CRC verify, RAIM5 demotion, elastic n->m reshard —
    is the same `_load_with_demotion` machinery every other tier uses.
    Only manifest-complete families are candidates, so a torn upload can
    never be surfaced."""
    from repro_torch.store.base import StoreError
    from repro_torch.store.manifest import object_families

    st = stats if stats is not None else LoadStats()
    if not st.target_n:
        st.target_n = n
    try:
        families = object_families(store, prefix)
    except StoreError as e:
        raise RecoveryError(f"object store unavailable: {e!r}")
    if step is not None:
        if step not in families:
            raise RecoveryError(
                f"no remote family for step {step} under {prefix!r}")
        candidates = [step]
    else:
        candidates = sorted(families, reverse=True)
    last_err: Optional[Exception] = None
    for cand in candidates:
        try:
            # a manifest-complete family names all saved_n shards; a
            # shard object deleted since (GC race, remote loss) becomes
            # a missing member the RAIM5 demotion path reconstructs.
            # Delta manifests chain through `base_step` links back to a
            # full keyframe family, served as one overlay source.
            src, holders = _open_remote_chain(store, prefix, cand,
                                              retry=retry)
            saved_n = src.n
            st.saved_n = saved_n
            st.resharded = bool(n) and saved_n != n
            absent = [nd for nd in range(saved_n) if nd not in holders]
            meta = spec = None
            for nd in holders:
                try:
                    meta = src.meta(nd)
                    spec = FlatSpec.from_json(meta["spec"])
                    break
                except Exception:
                    continue
            if spec is None:
                raise RecoveryError(
                    f"remote family step {cand}: no member meta parseable")
            tree, usable, corrupt = _load_with_demotion(
                saved_n, src.total_bytes, template, spec,
                lambda members: src, holders, absent, need, device_put, st,
                sched=sched)
            return tree, src.step, meta.get("extra", {})
        except (RecoveryError, StoreError, KeyError, TypeError, ValueError,
                EOFError, pickle.UnpicklingError) as e:
            last_err = e               # malformed family: try the next one
            continue
    if step is not None and last_err is not None:
        raise RecoveryError(str(last_err))
    raise RecoveryError(
        f"no complete remote family available"
        + (f" ({last_err})" if last_err else ""))
