"""Stripe-granular multipart shard upload.

Runs inside the SMP's persist worker thread, off the training path:
the shard object is streamed as one part for the pickled head plus one
part per RAIM5 stripe block of the pinned snapshot buffer (own region
sliced at `seg` = block size, parity tail as the final part), then
composed.  Parts are memoryview slices of the shared-memory buffer —
no staging copy — and each part write is wrapped in bounded
retry-with-backoff so a transient remote error never loses a family.

The optional `throttle` callback is the SMP's persist token bucket: it
charges each part before the write, so remote upload bandwidth and the
local `.reft` writes share one `persist_bw_limit` budget.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.store.base import ObjectStore, RetryPolicy, call_with_retries, \
    retry_policy


def upload_shard(store: ObjectStore, key: str, head_blob: bytes, buf,
                 seg: int, own_bytes: int, *,
                 retry=None,
                 throttle: Optional[Callable[[int], None]] = None) -> dict:
    """Upload one member shard (head + pinned buffer) as a multipart
    object at `key`.  `buf` is the member's full snapshot buffer (own
    region then parity); `seg` is the stripe block size the own region
    is sliced at.  Returns the upload record the family manifest stores.
    """
    t0 = time.perf_counter()
    pol = retry_policy(retry)
    view = memoryview(buf).cast("B")
    parts = [bytes(head_blob)]
    for lo in range(0, own_bytes, seg):
        parts.append(view[lo:min(lo + seg, own_bytes)])
    if own_bytes < len(view):                      # parity tail (n > 1)
        parts.append(view[own_bytes:])

    nbytes = 0
    retries = 0
    for i, data in enumerate(parts):
        if throttle is not None:
            throttle(len(data))
        _, r = call_with_retries(
            lambda i=i, data=data: store.put_part(key, i, data), pol)
        retries += r
        nbytes += len(data)
    _, r = call_with_retries(lambda: store.compose(key, len(parts)), pol)
    retries += r
    return {
        "key": key,
        "nbytes": nbytes,
        "data_off": len(head_blob),
        "parts": len(parts),
        "upload_bytes": nbytes,
        "upload_s": time.perf_counter() - t0,
        "retries": retries,
    }


_DELTA_PART_BYTES = 8 << 20


def upload_delta(store: ObjectStore, key: str, head_blob: bytes, buf,
                 extents, *, retry=None,
                 throttle: Optional[Callable[[int], None]] = None) -> dict:
    """Upload one member's `.reftd` delta shard: head (which records
    `base_step` + `extents`) followed by the raw bytes of each
    buffer-local extent, concatenated — byte-identical to the local
    `.reftd` file, so the chain loader parses either through one path.
    Extents are sliced into bounded parts; the object is usually tiny
    (that is the point), but a near-dense delta still streams."""
    t0 = time.perf_counter()
    pol = retry_policy(retry)
    view = memoryview(buf).cast("B")
    parts = [bytes(head_blob)]
    for lo, hi in extents:
        for a in range(int(lo), int(hi), _DELTA_PART_BYTES):
            parts.append(view[a:min(a + _DELTA_PART_BYTES, int(hi))])

    nbytes = 0
    retries = 0
    for i, data in enumerate(parts):
        if throttle is not None:
            throttle(len(data))
        _, r = call_with_retries(
            lambda i=i, data=data: store.put_part(key, i, data), pol)
        retries += r
        nbytes += len(data)
    _, r = call_with_retries(lambda: store.compose(key, len(parts)), pol)
    retries += r
    return {
        "key": key,
        "nbytes": nbytes,
        "data_off": len(head_blob),
        "parts": len(parts),
        "upload_bytes": nbytes,
        "upload_s": time.perf_counter() - t0,
        "retries": retries,
    }
