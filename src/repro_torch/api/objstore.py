"""`objstore` backend: the REFT stack + tier-4 object-store durability.

Extends `ReftCheckpointer` so every REFT-Ckpt round ALSO streams each
member's shard to an object store — stripe-granular multipart uploads
running on the SMPs' persist workers (seq-tagged tickets, refcounted
buffer pins: snapshots keep flowing through uploads) — and publishes a
per-family MANIFEST as the completeness marker once all shards landed.
Restore gains a fourth rung: when local `.reft` families are gone or
corrupt, the recovery ladder falls through to ranged remote reads
(`ObjectSource`), including elastic n->m reshard against remote
families.  A background `Scrubber` walks both durable tiers on a
cadence, verifies stripe digests, and repairs corrupt blocks from RAIM5
parity; its findings surface as `scrub` events and `scrub_*` stats.

spec.options (on top of the reft backend's):
  store          ObjectStore instance or config dict (default: a
                 LocalObjectStore under `<ckpt_dir>/objstore`)
  store_prefix   key prefix remote families live under ("families")
  store_retry    retry/backoff policy dict ({attempts, base_s, max_s,
                 mult}) for uploads, restores, and scrubs
  scrub_every_s  scrubber cadence; 0 disables the daemon (manual
                 `scrub()` still works)                      [300.0]
  scrub_repair   let the scrubber rewrite repaired blocks     [True]

The reft backend's `restore_sched` / `restore_bw_limit` options are
inherited and apply to every rung here too — remote ranged reads go
through the same straggler-aware chunk scheduler and token bucket as
shm and tier-3 file reads (docs/API.md "Straggler-aware loading").
"""
from __future__ import annotations

import os
from typing import Any, Optional

from repro_torch.api.backends import ReftCheckpointer
from repro_torch.api.registry import register_backend
from repro_torch.api.types import Checkpointer, CheckpointSpec
from repro_torch.store import (
    ScrubReport, Scrubber, build_manifest, put_manifest, store_from_config,
)


class ObjStoreCheckpointer(ReftCheckpointer):
    name = "objstore"

    def __init__(self, spec: CheckpointSpec, state_template: Any):
        super().__init__(spec, state_template)
        from repro_torch.ckpt.manager import CheckpointManager
        opt = spec.options
        store = opt.get("store") or {
            "kind": "local", "root": os.path.join(spec.ckpt_dir, "objstore")}
        self.store = store_from_config(store)
        self._store_cfg = self.store.config
        # a CONSTANT default prefix (not run-scoped): a restarted run
        # must find the previous run's remote families
        self.store_prefix = opt.get("store_prefix", "families")
        self.store_retry = opt.get("store_retry")
        # swap in a store-aware manager: remote families join latest()
        # and GC on equal footing with local ones
        self.manager = CheckpointManager(
            spec.ckpt_dir, spec.sg_size, keep=spec.keep, store=self.store,
            remote_prefix=self.store_prefix)
        self.scrubber = Scrubber(
            ckpt_dir=spec.ckpt_dir, store=self.store,
            prefix=self.store_prefix,
            interval_s=float(opt.get("scrub_every_s", 300.0)),
            repair=bool(opt.get("scrub_repair", True)),
            skip_steps=self.manager.inflight_steps,
            on_report=self._on_scrub, retry=self.store_retry)
        if self.scrubber.interval_s > 0:
            self.scrubber.start()

    # ---------------------------------------------------- tier-4 hooks
    def _persist_remote(self) -> Optional[dict]:
        return {"store": self._store_cfg, "prefix": self.store_prefix,
                "retry": self.store_retry}

    def _ladder_extra(self) -> dict:
        return {"store": self.store, "store_prefix": self.store_prefix,
                "store_retry": self.store_retry}

    def _emit_rounds(self, out):
        # publish the family manifest BEFORE the base class commits and
        # emits: the manifest is the remote completeness marker, so an
        # upload round only counts once it exists — a round that fails
        # here is downgraded to persist-error and its orphans left to GC
        for r in out:
            ups = r.get("uploads")
            if not r["ok"] or not ups:
                continue
            try:
                man = build_manifest(
                    run=self.group.run, step=r["step"], n=self.group.n,
                    total_bytes=self.group.total_bytes, nodes=ups)
                put_manifest(self.store, self.store_prefix, man,
                             retry=self.store_retry)
            except Exception as e:
                r["ok"] = False
                r["errors"].append(f"manifest: {e!r}")
        return super()._emit_rounds(out)

    # --------------------------------------------------------- scrubbing
    def scrub(self):
        """One synchronous scrub pass over both durable tiers (the
        daemon keeps its own cadence)."""
        return self.scrubber.scan_once()

    def _on_scrub(self, rep: ScrubReport) -> None:
        if rep.clean and not rep.repaired:
            return                       # quiet pass: stats only
        kind = "scrub-repair" if rep.repaired else "scrub"
        self.emit(kind, rep.step,
                  detail=(f"{rep.kind}: corrupt={rep.corrupt} "
                          f"repaired={rep.repaired} "
                          f"unrepairable={rep.unrepairable} "
                          f"errors={rep.errors}"))

    def stats(self):
        out = super().stats()
        out.update(self.scrubber.stats())
        return out

    def close(self):
        self.scrubber.stop()
        super().close()


@register_backend("objstore")
def _make_objstore(spec: CheckpointSpec, template: Any) -> Checkpointer:
    return ObjStoreCheckpointer(spec, template)
