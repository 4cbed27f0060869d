"""Tier-4 object-store durability (docs/API.md "Tier-4 object store").

`ObjectStore` protocol + filesystem/fault-injecting implementations,
stripe-granular multipart shard upload, per-family remote manifests,
and the background integrity `Scrubber`.  The `objstore` backend in
`repro_torch.api.objstore` assembles these behind the uniform `Checkpointer`
facade.
"""
from repro_torch.store.base import (
    NotFoundError, ObjectStore, RetryPolicy, StoreError,
    TransientStoreError, call_with_retries, retrier, retry_policy,
    store_from_config,
)
from repro_torch.store.flaky import FlakyStore
from repro_torch.store.local import LocalObjectStore
from repro_torch.store.manifest import (
    MANIFEST_NAME, build_manifest, delete_family, delta_shard_key,
    family_prefix, list_step_prefixes, load_manifest, manifest_base_step,
    manifest_key, object_families, put_manifest, shard_key,
)
from repro_torch.store.scrub import (
    ScrubReport, Scrubber, scrub_family, scrub_local_dir,
    scrub_object_store,
)
from repro_torch.store.upload import upload_delta, upload_shard

__all__ = [
    "ObjectStore", "LocalObjectStore", "FlakyStore",
    "StoreError", "NotFoundError", "TransientStoreError",
    "RetryPolicy", "retry_policy", "call_with_retries", "retrier",
    "store_from_config", "upload_shard", "upload_delta",
    "MANIFEST_NAME", "family_prefix", "shard_key", "delta_shard_key",
    "manifest_key", "build_manifest", "put_manifest", "load_manifest",
    "manifest_base_step", "object_families", "list_step_prefixes",
    "delete_family",
    "ScrubReport", "Scrubber", "scrub_family", "scrub_local_dir",
    "scrub_object_store",
]
