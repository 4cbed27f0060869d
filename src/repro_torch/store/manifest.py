"""Remote family layout + per-family manifests.

A persisted family lives under `<prefix>/step-<S>/`:

    <prefix>/step-<S>/node-<N>.reft      one shard object per member —
                                         the same head+buffer framing as
                                         the local `.reft` file, so one
                                         verify/parse path serves both
    <prefix>/step-<S>/MANIFEST.json      completeness marker + digests

The manifest is written LAST, after every shard object composed, so its
mere presence certifies the family: `CheckpointManager.latest()` and the
restore ladder only ever consider steps whose manifest exists, and a
torn upload (crash mid-stream) is invisible until GC sweeps its orphan
objects.  It records the saved topology (n, total_bytes, run) and, per
node, the shard key, byte offsets, and the stripe digest table — enough
for the scrubber to verify and parity-repair remote objects without
touching the shard heads at all.
"""
from __future__ import annotations

import json
import re
from typing import Dict, Optional, Set

from repro_torch.store.base import ObjectStore, call_with_retries, retry_policy

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_VERSION = 1

_STEP_DIR_RE = re.compile(r"(?:^|/)step-(\d+)/")
_MANIFEST_RE = re.compile(r"(?:^|/)step-(\d+)/" + re.escape(MANIFEST_NAME) + r"$")


def family_prefix(prefix: str, step: int) -> str:
    return f"{prefix}/step-{step}" if prefix else f"step-{step}"


def shard_key(prefix: str, step: int, node: int) -> str:
    return f"{family_prefix(prefix, step)}/node-{node}.reft"


def delta_shard_key(prefix: str, step: int, base_step: int,
                    node: int) -> str:
    """Key of a delta shard object: the base step rides in the name
    (mirroring the local `step-S-from-B-node-N.reftd` layout) so chain
    resolution and GC never have to open the object."""
    return (f"{family_prefix(prefix, step)}/"
            f"node-{node}-from-{int(base_step)}.reftd")


def manifest_key(prefix: str, step: int) -> str:
    return f"{family_prefix(prefix, step)}/{MANIFEST_NAME}"


def build_manifest(run: str, step: int, n: int, total_bytes: int,
                   nodes: Dict[int, dict]) -> dict:
    """Assemble the family manifest from per-node upload records (the
    `upload` info each persist round carries back: key, nbytes,
    data_off, parts, crc_stripes, crc_own, crc_parity)."""
    man = {
        "version": MANIFEST_VERSION,
        "run": run,
        "step": int(step),
        "n": int(n),
        "total_bytes": int(total_bytes),
        "nodes": {str(node): dict(rec) for node, rec in nodes.items()},
    }
    bases = {rec.get("base_step") for rec in nodes.values()} if nodes \
        else {None}
    if len(bases) == 1 and None not in bases:
        # uniform delta family (persist rounds are all-or-nothing): lift
        # the chain edge to the manifest top level so GC and chain
        # resolution read it without touching shard records
        man["kind"] = "delta"
        man["base_step"] = int(bases.pop())
    else:
        man["kind"] = "full"
    return man


def manifest_base_step(man: dict) -> Optional[int]:
    """The family's chain parent step, or None for a full family."""
    if man.get("kind") == "delta" and man.get("base_step") is not None:
        return int(man["base_step"])
    return None


def put_manifest(store: ObjectStore, prefix: str, man: dict,
                 retry=None) -> None:
    key = manifest_key(prefix, man["step"])
    blob = json.dumps(man, sort_keys=True).encode()
    call_with_retries(lambda: store.put(key, blob), retry_policy(retry))


def load_manifest(store: ObjectStore, prefix: str, step: int,
                  retry=None) -> dict:
    key = manifest_key(prefix, step)
    blob, _ = call_with_retries(lambda: store.read(key), retry_policy(retry))
    man = json.loads(bytes(blob).decode())
    man["nodes"] = {int(k): v for k, v in man.get("nodes", {}).items()}
    return man


def object_families(store: ObjectStore, prefix: str = "") -> Dict[int, str]:
    """Complete remote families: {step: family prefix} for every step
    whose manifest object exists (the completeness marker)."""
    out: Dict[int, str] = {}
    for key in store.list(prefix):
        m = _MANIFEST_RE.search(key)
        if m:
            out[int(m.group(1))] = key[: -len("/" + MANIFEST_NAME)]
    return out


def list_step_prefixes(store: ObjectStore, prefix: str = "") -> Set[int]:
    """Every step with ANY object under it — complete or torn.  The GC
    sweep diff's this against `object_families` to find orphans."""
    out: Set[int] = set()
    for key in store.list(prefix):
        m = _STEP_DIR_RE.search(key)
        if m:
            out.add(int(m.group(1)))
    return out


def delete_family(store: ObjectStore, prefix: str, step: int) -> int:
    return store.delete_prefix(family_prefix(prefix, step))
