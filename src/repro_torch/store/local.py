"""Filesystem-backed `ObjectStore` — the tests/CI tier-4 target.

Maps keys to files under one root.  Multipart semantics mirror a real
object store: `put_part` lands `<path>.partNNNNNN` scratch files (each
written tmp-then-rename, so a crashed part never half-exists),
`compose` concatenates them into a tmp file, fsyncs, and `os.replace`s
onto the final path — readers see either the previous object or the
complete new one, never a prefix.  `list` hides parts and scratch, so a
torn upload is invisible exactly like an uncomposed S3 multipart.

`write_range` is a deliberate extra beyond the `ObjectStore` protocol:
the scrubber uses it to patch a repaired stripe in place instead of
re-uploading a whole shard.  Wrappers forward it when the inner store
has one; callers fall back to read-patch-put when absent.
"""
from __future__ import annotations

import os
import tempfile
from typing import List

import numpy as np

from repro_torch.store.base import NotFoundError, ObjectStore, StoreError

_PART_SUFFIX = ".part"


def _is_scratch(name: str) -> bool:
    if ".tmp" in name:
        return True
    stem, sep, tail = name.rpartition(_PART_SUFFIX)
    return bool(stem) and sep == _PART_SUFFIX and tail.isdigit()


class LocalObjectStore(ObjectStore):
    kind = "local"

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    # --------------------------------------------------------- internals
    def _path(self, key: str) -> str:
        if not key or key.startswith("/") or ".." in key.split("/"):
            raise StoreError(f"bad object key {key!r}")
        return os.path.join(self.root, *key.split("/"))

    def _part_path(self, key: str, part: int) -> str:
        return f"{self._path(key)}{_PART_SUFFIX}{part:06d}"

    @staticmethod
    def _write_atomic(path: str, data) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=os.path.basename(path) + ".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            tmp = None
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    # ------------------------------------------------------------- write
    def put_part(self, key: str, part: int, data) -> None:
        if part < 0:
            raise StoreError(f"bad part index {part}")
        self._write_atomic(self._part_path(key, part), bytes(data))

    def compose(self, key: str, nparts: int) -> int:
        path = self._path(key)
        parts = [self._part_path(key, i) for i in range(nparts)]
        for p in parts:
            if not os.path.exists(p):
                raise StoreError(f"compose {key!r}: missing part {p}")
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=os.path.basename(path) + ".tmp")
        total = 0
        try:
            with os.fdopen(fd, "wb") as f:
                for p in parts:
                    with open(p, "rb") as pf:
                        while True:
                            chunk = pf.read(8 << 20)
                            if not chunk:
                                break
                            f.write(chunk)
                            total += len(chunk)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            tmp = None
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        for p in parts:
            try:
                os.unlink(p)
            except OSError:
                pass
        return total

    def put(self, key: str, data) -> None:
        # single fsync'd rename — skip the part shuffle for small blobs
        self._write_atomic(self._path(key), bytes(data))

    # -------------------------------------------------------------- read
    def read_range(self, key: str, lo: int, hi: int) -> np.ndarray:
        if hi < lo:
            raise StoreError(f"bad range [{lo}, {hi})")
        try:
            fd = os.open(self._path(key), os.O_RDONLY)
        except FileNotFoundError:
            raise NotFoundError(key) from None
        try:
            out = np.empty(hi - lo, dtype=np.uint8)
            view = memoryview(out).cast("B")
            got = 0
            while got < len(view):
                chunk = os.preadv(fd, [view[got:]], lo + got)
                if chunk <= 0:
                    raise StoreError(
                        f"short read on {key!r}: wanted [{lo}, {hi}), "
                        f"got {got} bytes")
                got += chunk
            return out
        finally:
            os.close(fd)

    def size(self, key: str) -> int:
        try:
            return os.stat(self._path(key)).st_size
        except FileNotFoundError:
            raise NotFoundError(key) from None

    # --------------------------------------------------- listing / admin
    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _, names in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            base = "" if rel == "." else rel.replace(os.sep, "/") + "/"
            for name in names:
                if _is_scratch(name):
                    continue
                key = base + name
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass
        self._prune(os.path.dirname(self._path(key)))

    def delete_prefix(self, prefix: str) -> int:
        n = super().delete_prefix(prefix)
        # sweep scratch (torn parts under a GC'd family) too
        root = self._path(prefix) if prefix else self.root
        if os.path.isdir(root):
            for dirpath, _, names in os.walk(root, topdown=False):
                for name in names:
                    if _is_scratch(name):
                        try:
                            os.unlink(os.path.join(dirpath, name))
                        except OSError:
                            pass
                self._prune(dirpath)
        return n

    def _prune(self, path: str) -> None:
        # drop now-empty directories so list()/walks stay cheap
        while path.startswith(self.root) and path != self.root:
            try:
                os.rmdir(path)
            except OSError:
                return
            path = os.path.dirname(path)

    # ----------------------------------------------------- scrub support
    def write_range(self, key: str, off: int, data) -> None:
        """Patch bytes in place at `off` (scrub repair fast path)."""
        try:
            fd = os.open(self._path(key), os.O_WRONLY)
        except FileNotFoundError:
            raise NotFoundError(key) from None
        try:
            os.pwrite(fd, bytes(data), off)
            os.fsync(fd)
        finally:
            os.close(fd)

    @property
    def config(self) -> dict:
        return {"kind": "local", "root": self.root}
