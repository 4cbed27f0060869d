"""Background integrity scrubber for persisted REFT-Ckpt families.

Durable shards rot silently: a local `.reft` file or a remote shard
object can lose a stripe to bitrot/partial overwrite long before any
restore reads it — and the restore that finally notices is the one that
can least afford a missing rung.  The scrubber walks persisted families
on a cadence, re-verifies every stripe digest (the same per-block CRC
table the loader folds into restore reads), and — because the shard
layout IS RAIM5 — re-derives a lost/corrupt block from the surviving
stripe members and parity, rewriting it in place:

  data block (s, j) on node v   <- XOR(parity of stripe s,
                                       sibling blocks (s, j') j' != j)
  parity of stripe s on node s  <- XOR(data blocks (s, 0..n-2))

Both durable tiers scrub through one engine: `_FileFamily` adapts a
local family (positioned reads/writes around the pickled head),
`_ObjectFamily` a remote one (manifest digests + `read_range`, patching
via the store's `write_range` fast path when offered).  A stripe whose
digest table never recorded a CRC is skipped, not failed; a block whose
reconstruction inputs are themselves corrupt is reported unrepairable
(n == 1 families carry no parity at all).

`Scrubber` is the daemon: scan every `interval_s`, skip steps with
in-flight persists, fold results into `stats()` (surfaced through the
session like every other backend counter) and hand each `ScrubReport`
to an `on_report` callback (the objstore backend emits scrub events
from it).
"""
from __future__ import annotations

import os
import pickle
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analyze.lockgraph import named_lock
from repro_torch.store.base import NotFoundError, ObjectStore, StoreError, \
    call_with_retries, retry_policy


@dataclass
class ScrubReport:
    """One family's scrub outcome."""
    step: int
    kind: str                       # "file" | "object"
    members: int = 0
    segments: int = 0               # digest-verified blocks (incl. parity)
    bytes_verified: int = 0
    corrupt: List[str] = field(default_factory=list)    # found this pass
    repaired: List[str] = field(default_factory=list)
    unrepairable: List[str] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not (self.corrupt or self.errors)


# ------------------------------------------------------------- adapters
class _FileFamily:
    """Local `.reft` family: digests from the pickled heads, positioned
    reads/writes offset past them."""

    kind = "file"

    def __init__(self, step: int, paths: Dict[int, str]):
        from repro_torch.core.smp import NodeLayout
        self.step = step
        self._paths = dict(paths)
        self._off: Dict[int, int] = {}
        self._stripes: Dict[int, Optional[dict]] = {}
        self._parity_crc: Dict[int, Optional[int]] = {}
        for node, path in sorted(paths.items()):
            with open(path, "rb") as f:
                head = pickle.load(f)
                self._off[node] = f.tell()
            self._stripes[node] = head.get("crc_stripes")
            try:
                meta = pickle.loads(head["meta"])
                self._parity_crc[node] = meta.get("crc_parity")
            except Exception:
                self._parity_crc[node] = None
            n, total = head["n"], head["total_bytes"]
        self.n, self.total_bytes = n, total
        self.layout = NodeLayout(self.n, self.total_bytes)

    @property
    def nodes(self) -> List[int]:
        return sorted(self._paths)

    def stripe_digests(self, node: int) -> Optional[dict]:
        return self._stripes[node]

    def parity_digest(self, node: int) -> Optional[int]:
        return self._parity_crc[node]

    def read(self, node: int, lo: int, hi: int) -> np.ndarray:
        with open(self._paths[node], "rb") as f:
            return np.frombuffer(
                os.pread(f.fileno(), hi - lo, self._off[node] + lo),
                np.uint8)

    def write(self, node: int, off: int, data: np.ndarray) -> None:
        fd = os.open(self._paths[node], os.O_WRONLY)
        try:
            os.pwrite(fd, bytes(memoryview(data).cast("B")),
                      self._off[node] + off)
            os.fsync(fd)
        finally:
            os.close(fd)


class _ObjectFamily:
    """Remote family: digests from the MANIFEST, ranged reads offset past
    the head blob; repair patches in place via `write_range` when the
    store offers it, else read-patch-put."""

    kind = "object"

    def __init__(self, store: ObjectStore, manifest: dict, retry=None):
        from repro_torch.core.smp import NodeLayout
        self._store = store
        self._pol = retry_policy(retry)
        self.step = int(manifest["step"])
        self.n = int(manifest["n"])
        self.total_bytes = int(manifest["total_bytes"])
        self.layout = NodeLayout(self.n, self.total_bytes)
        self._nodes = {int(k): v for k, v in manifest["nodes"].items()}

    @property
    def nodes(self) -> List[int]:
        return sorted(self._nodes)

    def stripe_digests(self, node: int) -> Optional[dict]:
        return self._nodes[node].get("crc_stripes")

    def parity_digest(self, node: int) -> Optional[int]:
        return self._nodes[node].get("crc_parity")

    def read(self, node: int, lo: int, hi: int) -> np.ndarray:
        ent = self._nodes[node]
        off = int(ent["data_off"])
        out, _ = call_with_retries(
            lambda: self._store.read_range(ent["key"], off + lo, off + hi),
            self._pol)
        return out

    def write(self, node: int, off: int, data: np.ndarray) -> None:
        ent = self._nodes[node]
        blob = bytes(memoryview(data).cast("B"))
        base = int(ent["data_off"]) + off
        if hasattr(self._store, "write_range"):
            call_with_retries(
                lambda: self._store.write_range(ent["key"], base, blob),
                self._pol)
            return
        whole, _ = call_with_retries(
            lambda: bytearray(self._store.read(ent["key"])), self._pol)
        whole[base:base + len(blob)] = blob
        call_with_retries(
            lambda: self._store.put(ent["key"], bytes(whole)), self._pol)


class _ChainFamily:
    """A delta family resolved against its keyframe: reads go through
    `ChainSource` (newest layer first, holes fall through), so the bytes
    verified are the RESOLVED step's — checked against the NEWEST delta
    head's merged stripe table, exactly what a restore would verify.
    Repair WRITES are routed via `ChainSource.locate_spans` to whichever
    layer actually serves each span (a keyframe hole's reconstruction IS
    the keyframe's original bytes — nothing newer overlays it — so
    patching in place is sound at every link)."""

    kind = "chain"

    def __init__(self, src, write_base, write_layer):
        # write_base(node, local_off, data);
        # write_layer(layer_idx, node, payload_off, data)
        self._src = src
        self.step = src.step
        self.n = src.n
        self.total_bytes = src.total_bytes
        self.layout = src.layout
        self._write_base = write_base
        self._write_layer = write_layer

    @property
    def nodes(self) -> List[int]:
        return self._src.nodes

    def stripe_digests(self, node: int) -> Optional[dict]:
        return self._src.layers[-1].head(node).get("crc_stripes")

    def parity_digest(self, node: int) -> Optional[int]:
        try:
            return self._src.meta(node).get("crc_parity")
        except Exception:
            return None

    def read(self, node: int, lo: int, hi: int) -> np.ndarray:
        return self._src.read_local(node, lo, hi)

    def write(self, node: int, off: int, data) -> None:
        view = memoryview(data).cast("B")
        end = off + len(view)
        for li, poff, a, b in self._src.locate_spans(node, off, end):
            chunk = bytes(view[a - off:b - off])
            if li < 0:
                self._write_base(node, a, chunk)
            else:
                self._write_layer(li, node, poff, chunk)

    def close(self) -> None:
        self._src.close()


def _pwrite_at(path: str, off: int, blob: bytes) -> None:
    fd = os.open(path, os.O_WRONLY)
    try:
        os.pwrite(fd, blob, off)
        os.fsync(fd)
    finally:
        os.close(fd)


def _head_off(path: str) -> int:
    with open(path, "rb") as f:
        pickle.load(f)
        return f.tell()


def _chain_file_family(ckpt_dir: str, step: int, full, deltas
                       ) -> Optional[_ChainFamily]:
    """Build the scrub adapter for one local delta step, or None when
    its chain does not resolve."""
    from repro_torch.core.recovery import (
        _delta_paths, _family_paths, _open_chain, resolve_chain,
    )
    res = resolve_chain(ckpt_dir, step, full, deltas)
    if res is None:
        return None
    kf, links = res
    src = _open_chain(ckpt_dir, step, full, deltas)
    try:
        nodes = sorted(range(src.n))
        base_paths = _family_paths(ckpt_dir, kf, nodes)
        base_off = {nd: _head_off(p) for nd, p in base_paths.items()}
        layer_paths = [_delta_paths(ckpt_dir, s, b, nodes)
                       for s, b in links]
        layer_off = [{nd: _head_off(p) for nd, p in lp.items()}
                     for lp in layer_paths]
    except BaseException:
        src.close()
        raise

    def write_base(node, off, blob):
        _pwrite_at(base_paths[node], base_off[node] + off, blob)

    def write_layer(li, node, poff, blob):
        _pwrite_at(layer_paths[li][node], layer_off[li][node] + poff, blob)

    return _ChainFamily(src, write_base, write_layer)


def _chain_object_family(store: ObjectStore, prefix: str, step: int,
                         retry=None) -> _ChainFamily:
    """Build the scrub adapter for one remote delta step by walking its
    manifest `base_step` links down to the full keyframe manifest."""
    from repro_torch.core.loader import ChainSource, DeltaLayer, ObjectSource
    from repro_torch.store.base import retrier
    from repro_torch.store.manifest import load_manifest, manifest_base_step

    pol = retry_policy(retry)
    wrap = retrier(retry)
    man = load_manifest(store, prefix, step, retry=retry)
    link_mans: List[dict] = []
    seen = {int(step)}
    while True:
        base = manifest_base_step(man)
        if base is None:
            break
        link_mans.append(man)
        if base in seen:
            raise ValueError(f"delta chain for step {step} cycles at {base}")
        seen.add(base)
        man = load_manifest(store, prefix, base, retry=retry)
    link_mans.reverse()                              # oldest -> newest
    src = ChainSource(ObjectSource(store, man, retry=wrap),
                      [DeltaLayer.from_objects(store, m, retry=wrap)
                       for m in link_mans])

    def put_at(key, off, blob):
        if hasattr(store, "write_range"):
            call_with_retries(lambda: store.write_range(key, off, blob), pol)
            return
        whole, _ = call_with_retries(lambda: bytearray(store.read(key)), pol)
        whole[off:off + len(blob)] = blob
        call_with_retries(lambda: store.put(key, bytes(whole)), pol)

    base_nodes = {int(k): v for k, v in man["nodes"].items()}
    layer_nodes = [{int(k): v for k, v in m["nodes"].items()}
                   for m in link_mans]

    def write_base(node, off, blob):
        ent = base_nodes[node]
        put_at(ent["key"], int(ent["data_off"]) + off, blob)

    def write_layer(li, node, poff, blob):
        ent = layer_nodes[li][node]
        put_at(ent["key"], int(ent["data_off"]) + poff, blob)

    return _ChainFamily(src, write_base, write_layer)


# ----------------------------------------------------------- family scrub
def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(memoryview(arr).cast("B")) & 0xFFFFFFFF


def scrub_family(fam, repair: bool = True) -> ScrubReport:
    """Verify every recorded stripe digest of one family; with `repair`,
    reconstruct corrupt blocks from RAIM5 parity and rewrite them.
    Returns the pass's report (`corrupt` lists what verification found,
    `repaired`/`unrepairable` how repair fared)."""
    from repro_torch.core import raim5

    rep = ScrubReport(step=fam.step, kind=fam.kind, members=len(fam.nodes))
    n, lay = fam.n, fam.layout
    bs = lay.bs if n > 1 else lay.own_bytes

    bad_data: set = set()           # (node, local_index)
    bad_parity: set = set()         # node (== stripe)
    for node in fam.nodes:
        digs = fam.stripe_digests(node)
        crcs = (digs or {}).get("crcs") or []
        nblocks = (n - 1) if n > 1 else 1
        for li in range(min(nblocks, len(crcs))):
            blob = fam.read(node, li * bs, (li + 1) * bs)
            rep.segments += 1
            rep.bytes_verified += blob.nbytes
            if _crc(blob) != crcs[li] & 0xFFFFFFFF:
                bad_data.add((node, li))
                rep.corrupt.append(f"node{node}:block{li}")
        pcrc = fam.parity_digest(node)
        if n > 1 and pcrc is not None:
            blob = fam.read(node, lay.own_bytes, lay.own_bytes + bs)
            rep.segments += 1
            rep.bytes_verified += blob.nbytes
            if _crc(blob) != pcrc & 0xFFFFFFFF:
                bad_parity.add(node)
                rep.corrupt.append(f"node{node}:parity")

    if not repair or not (bad_data or bad_parity):
        return rep

    if n == 1:                      # no parity, nothing to derive from
        rep.unrepairable = list(rep.corrupt)
        return rep

    def data_ref(node: int, li: int) -> Tuple[int, int]:
        r = raim5.data_blocks_of_node(node, n)[li]
        return r.stripe, r.index

    def slot(s: int, j: int) -> Tuple[int, int]:
        node = raim5.node_of_block(s, j, n)
        return node, raim5.local_block_index(node, s, j, n)

    # fixpoint: each repaired block may unlock another (a stripe with a
    # bad parity AND a bad data block is only repairable if one of the
    # two becomes clean first — it never does; but independent stripes
    # heal in any order)
    progress = True
    while progress and (bad_data or bad_parity):
        progress = False
        for node, li in sorted(bad_data):
            s, j = data_ref(node, li)
            if s in bad_parity:
                continue
            sibs = [slot(s, k) for k in range(n - 1) if k != j]
            if any(sl in bad_data for sl in sibs):
                continue
            blocks = [fam.read(s, lay.own_bytes, lay.own_bytes + bs)]
            blocks += [fam.read(sn, sl * bs, (sl + 1) * bs)
                       for sn, sl in sibs]
            fixed = raim5.xor_blocks(blocks)
            fam.write(node, li * bs, fixed)
            if _crc(fixed) == \
                    fam.stripe_digests(node)["crcs"][li] & 0xFFFFFFFF:
                bad_data.discard((node, li))
                rep.repaired.append(f"node{node}:block{li}")
                progress = True
        for s in sorted(bad_parity):
            slots = [slot(s, k) for k in range(n - 1)]
            if any(sl in bad_data for sl in slots):
                continue
            blocks = [fam.read(sn, sl * bs, (sl + 1) * bs)
                      for sn, sl in slots]
            fixed = raim5.xor_blocks(blocks)
            fam.write(s, lay.own_bytes, fixed)
            pcrc = fam.parity_digest(s)
            if pcrc is None or _crc(fixed) == pcrc & 0xFFFFFFFF:
                bad_parity.discard(s)
                rep.repaired.append(f"node{s}:parity")
                progress = True

    rep.unrepairable = sorted([f"node{nd}:block{li}"
                               for nd, li in bad_data]
                              + [f"node{s}:parity" for s in bad_parity])
    return rep


# ------------------------------------------------------------ tier walks
def scrub_local_dir(ckpt_dir: str, repair: bool = True,
                    skip_steps=()) -> List[ScrubReport]:
    """Scrub every COMPLETE local family under `ckpt_dir` (a family is
    complete when all shards of its own saved n are on disk — torn ones
    belong to GC, in-flight ones to `skip_steps`)."""
    from repro_torch.core.recovery import checkpoint_families, delta_families
    skip = {int(s) for s in skip_steps}
    out: List[ScrubReport] = []
    full = checkpoint_families(ckpt_dir)
    deltas = delta_families(ckpt_dir)
    for step, nodes in sorted(full.items()):
        if step in skip:
            continue
        paths = {nd: os.path.join(ckpt_dir, f"step-{step}-node-{nd}.reft")
                 for nd in nodes}
        try:
            fam = _FileFamily(step, paths)
            if set(fam.nodes) != set(range(fam.n)):
                continue                       # torn: GC's problem
            out.append(scrub_family(fam, repair=repair))
        except Exception as e:                 # head unreadable / racing GC
            rep = ScrubReport(step=step, kind="file")
            rep.errors.append(repr(e))
            out.append(rep)
    for step in sorted(set(deltas) - set(full)):
        if step in skip:
            continue
        fam = None
        try:
            fam = _chain_file_family(ckpt_dir, step, full, deltas)
            if fam is None:
                continue                       # torn chain: GC's problem
            out.append(scrub_family(fam, repair=repair))
        except Exception as e:
            rep = ScrubReport(step=step, kind="chain")
            rep.errors.append(repr(e))
            out.append(rep)
        finally:
            if fam is not None:
                fam.close()
    return out


def scrub_object_store(store: ObjectStore, prefix: str = "families",
                       repair: bool = True, skip_steps=(),
                       retry=None) -> List[ScrubReport]:
    """Scrub every manifest-complete remote family under `prefix`."""
    from repro_torch.store.manifest import load_manifest, object_families
    skip = {int(s) for s in skip_steps}
    out: List[ScrubReport] = []
    try:
        families = object_families(store, prefix)
    except StoreError:
        return out
    from repro_torch.store.manifest import manifest_base_step
    for step in sorted(families):
        if step in skip:
            continue
        try:
            man = load_manifest(store, prefix, step, retry=retry)
            if manifest_base_step(man) is not None:
                fam = _chain_object_family(store, prefix, step, retry=retry)
            else:
                fam = _ObjectFamily(store, man, retry=retry)
            out.append(scrub_family(fam, repair=repair))
        except (StoreError, NotFoundError, KeyError, ValueError) as e:
            rep = ScrubReport(step=step, kind="object")
            rep.errors.append(repr(e))
            out.append(rep)
    return out


# --------------------------------------------------------------- daemon
class Scrubber:
    """Cadenced integrity scans over both durable tiers.

    `skip_steps` is a zero-arg callable returning steps to leave alone
    this pass (the manager's in-flight persists — their families are
    still growing); `on_report` receives each family's `ScrubReport`."""

    def __init__(self, ckpt_dir: Optional[str] = None,
                 store: Optional[ObjectStore] = None,
                 prefix: str = "families", *,
                 interval_s: float = 300.0, repair: bool = True,
                 skip_steps: Optional[Callable[[], list]] = None,
                 on_report: Optional[Callable[[ScrubReport], None]] = None,
                 retry=None):
        self.ckpt_dir = ckpt_dir
        self.store = store
        self.prefix = prefix
        self.interval_s = float(interval_s)
        self.repair = repair
        self._skip = skip_steps or (lambda: ())
        self._on_report = on_report
        self._retry = retry
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = named_lock("scrub.stats")
        self._stats = {"scrub_passes": 0, "scrub_families": 0,
                       "scrub_segments": 0, "scrub_bytes": 0,
                       "scrub_corrupt": 0, "scrub_repaired": 0,
                       "scrub_unrepairable": 0, "scrub_errors": 0,
                       "scrub_seconds": 0.0}

    # ------------------------------------------------------------ scans
    def scan_once(self) -> List[ScrubReport]:
        """One synchronous pass over both tiers; folds into stats()."""
        t0 = time.perf_counter()
        skip = list(self._skip())
        reports: List[ScrubReport] = []
        if self.ckpt_dir:
            reports += scrub_local_dir(self.ckpt_dir, repair=self.repair,
                                       skip_steps=skip)
        if self.store is not None:
            reports += scrub_object_store(self.store, self.prefix,
                                          repair=self.repair,
                                          skip_steps=skip,
                                          retry=self._retry)
        with self._lock:
            st = self._stats
            st["scrub_passes"] += 1
            st["scrub_seconds"] += time.perf_counter() - t0
            for r in reports:
                st["scrub_families"] += 1
                st["scrub_segments"] += r.segments
                st["scrub_bytes"] += r.bytes_verified
                st["scrub_corrupt"] += len(r.corrupt)
                st["scrub_repaired"] += len(r.repaired)
                st["scrub_unrepairable"] += len(r.unrepairable)
                st["scrub_errors"] += len(r.errors)
        if self._on_report is not None:
            for r in reports:
                try:
                    self._on_report(r)
                except Exception:
                    pass
        return reports

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    # ----------------------------------------------------------- daemon
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="reft-scrubber")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scan_once()
            except Exception:
                with self._lock:
                    self._stats["scrub_errors"] += 1

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout)
