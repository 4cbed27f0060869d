"""Checkpoint retention manager for the REFT-Ckpt tier.

Production hygiene around the rare persisted checkpoints: an atomic
manifest of complete checkpoints (a step counts only when every SG
member's shard landed), keep-latest-k garbage collection, and discovery
for recovery.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

MANIFEST = "MANIFEST.json"


def scan_shards(ckpt_dir: str) -> Dict[int, List[int]]:
    """{step: [nodes present]} from the files on disk.  Delegates to the
    single anchored-regex parser (`recovery.checkpoint_families`) so GC
    and restore can never disagree on family membership."""
    from repro_torch.core.recovery import checkpoint_families
    return {s: sorted(ns)
            for s, ns in checkpoint_families(ckpt_dir).items()}


def _chain_closure(steps, deps: Dict[int, int]) -> set:
    """`steps` plus every chain ancestor reachable through `deps`
    (step -> base_step edges); cycle-safe."""
    out: set = set()
    for s in steps:
        cur = int(s)
        while cur not in out:
            out.add(cur)
            if cur not in deps:
                break
            cur = int(deps[cur])
    return out


def plan_gc(families: Dict[int, list], complete: set, keep_steps: set,
            spare_newest_torn: bool = False,
            inflight=(), deps: Optional[Dict[int, int]] = None) -> List[int]:
    """Steps to delete under keep-k-complete retention.

    One retention policy for every checkpoint layout (REFT shard families
    and disk ckpt families): complete families survive iff in
    `keep_steps`; torn families are garbage, except — when
    `spare_newest_torn` — the single newest torn family above the newest
    kept step, which may be a persist currently in flight.  `inflight`
    explicitly names steps with REGISTERED in-flight persists (the async
    REFT-Ckpt path): their still-growing families are never GC fodder, no
    matter how many of them are in the air or where they sit relative to
    the kept steps.

    `deps` (step -> base_step) carries the delta-chain edges: a keyframe
    or intermediate delta stays LIVE while any kept or spared step's
    chain passes through it (deleting it would orphan the dependents),
    and deletions CASCADE the other way — a step whose chain is torn
    anywhere below it is dead weight no matter how new it is."""
    deps = {int(k): int(v) for k, v in (deps or {}).items()}
    spare = {int(s) for s in inflight}
    if spare_newest_torn:
        newest_kept = max(keep_steps) if keep_steps else -1
        newest_torn = max((s for s in families
                           if s not in complete and s > newest_kept),
                          default=None)
        if newest_torn is not None:
            spare.add(newest_torn)
    # an in-flight or kept delta step needs its whole ancestry alive
    live = _chain_closure(set(keep_steps) | spare, deps)
    alive: Dict[int, bool] = {}

    def chain_ok(s: int) -> bool:
        if s in alive:
            return alive[s]
        alive[s] = False                         # cycle guard
        ok = s in complete and s in families
        if ok and s in deps:
            ok = chain_ok(deps[s])
        alive[s] = ok
        return ok

    return [s for s in families
            if s not in spare and not (s in live and chain_ok(s))]


class CheckpointManager:
    def __init__(self, ckpt_dir: str, n_members: int, *, keep: int = 3,
                 store=None, remote_prefix: str = "families"):
        self.dir = ckpt_dir
        self.n = n_members
        self.keep = keep
        self.store = store               # tier-4 ObjectStore (optional):
        self.remote_prefix = remote_prefix   # remote families join
        self._inflight: set = set()      # latest()/GC on equal footing
        os.makedirs(ckpt_dir, exist_ok=True)   # inflight steps: GC-exempt

    # --------------------------------------------------- in-flight gate
    def register_inflight(self, step: int) -> None:
        """Declare an async persist for `step` in flight: its (growing,
        currently torn) family is exempt from GC until resolved, so a
        commit racing the background write can never tear it."""
        self._inflight.add(int(step))

    def resolve_inflight(self, step: int) -> None:
        self._inflight.discard(int(step))

    def inflight_steps(self) -> List[int]:
        return sorted(self._inflight)

    # ------------------------------------------------------------ state
    def complete_steps(self) -> List[int]:
        """Steps for which every member's shard is on disk — including
        delta steps whose whole `.reftd` chain down to a complete
        keyframe family is on disk (a torn link poisons dependents)."""
        from repro_torch.core.recovery import restorable_steps
        return restorable_steps(self.dir, self.n)

    def _remote_manifests(self):
        """({step: manifest}, {step: base_step}) for every remote step
        whose manifest loads; deps only for delta manifests."""
        from repro_torch.store.base import StoreError
        from repro_torch.store.manifest import (
            load_manifest, manifest_base_step, object_families,
        )
        mans: Dict[int, dict] = {}
        for s in object_families(self.store, self.remote_prefix):
            try:
                mans[s] = load_manifest(self.store, self.remote_prefix, s)
            except StoreError:
                continue
        deps = {}
        for s, man in mans.items():
            base = manifest_base_step(man)
            if base is not None:
                deps[s] = base
        return mans, deps

    def remote_complete_steps(self) -> List[int]:
        """Steps with a COMPLETE remote family (manifest present — the
        marker is written only after every shard object composed); a
        delta family counts only when every manifest on its `base_step`
        chain exists down to a full one.  Empty without a store or when
        the store is unreachable."""
        if self.store is None:
            return []
        from repro_torch.store.base import StoreError
        try:
            mans, deps = self._remote_manifests()
        except StoreError:
            return []
        out = []
        for s in mans:
            cur, seen = s, set()
            while cur in deps and cur in mans and cur not in seen:
                seen.add(cur)
                cur = deps[cur]
            if cur in mans and cur not in deps:   # bottoms out at a full
                out.append(s)                     # manifest, cycle-free
        return sorted(out)

    def latest(self) -> Optional[int]:
        """Newest COMPLETE, fully-landed step — local `.reft` families
        and manifest-complete remote families on equal footing; a family
        whose async persist is still in flight is never reported (its
        shards may all exist while a final fsync or manifest write is
        pending)."""
        steps = [s for s in set(self.complete_steps())
                 | set(self.remote_complete_steps())
                 if s not in self._inflight]
        return max(steps) if steps else None

    # --------------------------------------------------------- manifest
    def commit(self) -> dict:
        """Atomically publish the manifest and GC beyond keep-latest-k."""
        steps = self.complete_steps()
        kept = steps[-self.keep:] if self.keep else steps
        manifest = {"n_members": self.n, "complete_steps": kept}
        if self.store is not None:
            manifest["remote_steps"] = self.remote_complete_steps()
        tmp = os.path.join(self.dir, MANIFEST + ".tmp")
        try:
            with open(tmp, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.dir, MANIFEST))
        finally:
            try:
                os.unlink(tmp)             # no-op after a clean replace
            except FileNotFoundError:
                pass
        self._gc(set(kept))
        self._gc_remote()
        return manifest

    def read_manifest(self) -> Optional[dict]:
        try:
            with open(os.path.join(self.dir, MANIFEST)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def _gc(self, keep_steps: set) -> int:
        """Drop superseded complete steps AND torn (incomplete) families.

        Torn families used to survive whenever their step was >= the newest
        kept step, so every crashed partial checkpoint leaked forever; see
        `plan_gc` for the policy (a possibly in-flight newest torn family
        is spared)."""
        from repro_torch.core.recovery import (
            delta_families, resolve_chain, restorable_steps,
        )
        removed = 0
        shards = scan_shards(self.dir)
        deltas = delta_families(self.dir)
        families = {s: None for s in set(shards) | set(deltas)}
        complete = set(restorable_steps(self.dir, self.n))
        full = {s: set(ns) for s, ns in shards.items()}
        deps: Dict[int, int] = {}
        for s in deltas:
            if s in shards:
                continue
            res = resolve_chain(self.dir, s, full, deltas)
            if res is not None:
                for st, base in res[1]:
                    deps[st] = base
        for s in plan_gc(families, complete, set(keep_steps),
                         spare_newest_torn=True, inflight=self._inflight,
                         deps=deps):
            for node in shards.get(s, ()):
                try:
                    os.remove(os.path.join(
                        self.dir, f"step-{s}-node-{node}.reft"))
                    removed += 1
                except FileNotFoundError:
                    pass
            for base, nodes in deltas.get(s, {}).items():
                for node in nodes:
                    try:
                        os.remove(os.path.join(
                            self.dir,
                            f"step-{s}-from-{base}-node-{node}.reftd"))
                        removed += 1
                    except FileNotFoundError:
                        pass
        return removed

    def _gc_remote(self) -> int:
        """Same keep-k policy over remote families: complete = manifest
        present; torn = shard/part objects with no manifest (a crashed
        upload's orphans).  Store errors skip the sweep — retention is
        best-effort, never a persist-path failure."""
        if self.store is None:
            return 0
        from repro_torch.store.base import StoreError
        from repro_torch.store.manifest import delete_family, list_step_prefixes
        try:
            complete = set(self.remote_complete_steps())
            mans, deps = self._remote_manifests()
            families = {s: None
                        for s in list_step_prefixes(self.store,
                                                    self.remote_prefix)}
            kept = sorted(complete)[-self.keep:] if self.keep \
                else sorted(complete)
            removed = 0
            for s in plan_gc(families, complete, set(kept),
                             spare_newest_torn=True,
                             inflight=self._inflight, deps=deps):
                removed += delete_family(self.store, self.remote_prefix, s)
            return removed
        except StoreError:
            return 0
