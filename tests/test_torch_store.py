"""The port's tier-4 object store (`repro_torch.store`) against the JAX
package's (`repro.store`), on the same inputs:

  * `LocalObjectStore` objects (multipart parts composed, whole puts,
    ranged writes) are byte-identical file for file, and `FlakyStore`
    trips and retries on the same operations;
  * `upload_shard` / `upload_delta` give the same parts, records and
    objects, and ranged reads return the stripe slices;
  * manifests are equal as bytes and list the same families;
  * the scrubber finds and repairs a damaged data block and a damaged
    parity region, in a local `.reft` family and in an object family,
    with reports and repaired bytes equal to the reference's;
  * the `objstore` backend of each package persists a small state from
    `convert.py` into byte-identical `.reft` files and shard objects,
    and each package's `restore_from_objstore` reads the other's.
"""
import json
import os
import pickle
import zlib
from dataclasses import asdict

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import repro.store as J
import repro_torch.store as T
from repro.api import CheckpointSpec as JaxSpec
from repro.api.registry import create_checkpointer as jax_create
from repro.core import raim5
from repro.core.recovery import restore_from_objstore as jax_restore_obj
from repro.core.treebytes import leaf_arrays as jax_leaf_arrays
from repro.store import scrub as jax_scrub
from repro_torch import convert
from repro_torch.api import CheckpointSpec
from repro_torch.api.registry import create_checkpointer
from repro_torch.core.recovery import restore_from_objstore
from repro_torch.core.treebytes import host_bytes, leaf_arrays
from repro_torch.store import scrub as torch_scrub

PKGS = {"jax": J, "torch": T}


def _tree_files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _store_ops(pkg, store, log):
    """One fixed sequence of store operations, each through the package's
    own retry loop; `log` collects what each returned."""
    pol = pkg.RetryPolicy(attempts=6, base_s=0.0)

    def call(fn):
        got, retries = pkg.call_with_retries(fn, pol, sleep=lambda s: None)
        log.append(("retries", retries))
        return got

    call(lambda: store.put_part("fam/step-3/node-0.reft", 0, b"head|"))
    call(lambda: store.put_part("fam/step-3/node-0.reft", 1,
                                memoryview(bytes(range(256)))))
    call(lambda: store.put_part("fam/step-3/node-0.reft", 2, b"\x00" * 700))
    log.append(call(lambda: store.compose("fam/step-3/node-0.reft", 3)))
    call(lambda: store.put("fam/step-3/MANIFEST.json", b'{"x": 1}'))
    call(lambda: store.put_part("fam/step-5/torn", 0, b"orphan"))
    call(lambda: store.write_range("fam/step-3/node-0.reft", 9, b"XYZ"))
    log.append(bytes(call(lambda: store.read_range(
        "fam/step-3/node-0.reft", 4, 300))))
    log.append(call(lambda: store.size("fam/step-3/node-0.reft")))
    log.append(call(lambda: store.list("fam")))
    log.append(call(lambda: store.exists("fam/step-5/torn")))
    call(lambda: store.put("other/a", b"a"))
    log.append(call(lambda: store.delete_prefix("other")))


@pytest.mark.parametrize("kind", ["local", "flaky"])
def test_store_objects_byte_identical(kind, tmp_path):
    logs, files, counts = {}, {}, {}
    for name, pkg in PKGS.items():
        root = str(tmp_path / name)
        cfg = {"kind": "local", "root": root}
        if kind == "flaky":
            cfg = {"kind": "flaky", "inner": cfg, "fail_every": 3,
                   "seed": 1}
        store = pkg.store_from_config(cfg)
        assert pkg.store_from_config(store.config).config == store.config
        logs[name] = [json.dumps(store.config).replace(root, "ROOT")]
        _store_ops(pkg, store, logs[name])
        files[name] = _tree_files(root)
        counts[name] = getattr(store, "counts", None)
    assert logs["torch"] == logs["jax"]
    assert files["torch"] == files["jax"]
    assert counts["torch"] == counts["jax"]
    if kind == "flaky":
        assert counts["torch"]["faults"] > 0
        assert any(x[1] for x in logs["torch"]
                   if isinstance(x, tuple) and x[0] == "retries")


def test_store_errors_match_reference(tmp_path):
    for pkg in PKGS.values():
        s = pkg.LocalObjectStore(str(tmp_path / pkg.__name__))
        with pytest.raises(pkg.NotFoundError):
            s.read_range("nope", 0, 1)
        for bad in ("", "/abs", "a/../b"):
            with pytest.raises(pkg.StoreError):
                s.put(bad, b"x")
        with pytest.raises(pkg.StoreError):
            pkg.store_from_config({"kind": "s3"})
        flaky = pkg.FlakyStore(s, fail_every=1)
        with pytest.raises(pkg.TransientStoreError):
            pkg.call_with_retries(lambda: flaky.put("k", b"x"),
                                  pkg.RetryPolicy(attempts=2, base_s=0.0),
                                  sleep=lambda s: None)


@pytest.mark.parametrize("n,bs", [(4, 1000), (3, 4096), (1, 777)])
def test_upload_shard_striping_and_ranged_reads(n, bs, tmp_path):
    rng = np.random.default_rng(n * bs)
    own = rng.integers(0, 256, (n - 1 if n > 1 else 1) * bs, np.uint8)
    parity = rng.integers(0, 256, bs if n > 1 else 0, np.uint8)
    buf = np.concatenate([own, parity])
    head = pickle.dumps({"node": 1, "n": n, "step": 4})
    recs, files = {}, {}
    for name, pkg in PKGS.items():
        store = pkg.LocalObjectStore(str(tmp_path / name))
        rec = pkg.upload_shard(store, pkg.shard_key("fam", 4, 1), head, buf,
                               seg=bs, own_bytes=own.nbytes)
        rec.pop("upload_s")
        recs[name] = rec
        files[name] = _tree_files(str(tmp_path / name))
        off = rec["data_off"]
        for lo, hi in ((0, bs), (bs - 1, min(bs + 1, buf.nbytes)),
                       (own.nbytes, buf.nbytes), (5, buf.nbytes)):
            got = store.read_range(rec["key"], off + lo, off + hi)
            assert np.array_equal(got, buf[lo:hi])
    assert recs["torch"] == recs["jax"]
    assert recs["torch"]["parts"] == 1 + (n - 1 if n > 1 else 1) \
        + (n > 1)
    assert files["torch"] == files["jax"]


def test_upload_delta_identical(tmp_path):
    buf = np.random.default_rng(2).integers(0, 256, 5000, np.uint8)
    ext = [(10, 600), (3000, 4999)]
    recs, files = {}, {}
    for name, pkg in PKGS.items():
        store = pkg.LocalObjectStore(str(tmp_path / name))
        key = pkg.delta_shard_key("fam", 6, 4, 0)
        rec = pkg.upload_delta(store, key, b"head", buf, ext)
        rec.pop("upload_s")
        recs[name] = rec
        files[name] = _tree_files(str(tmp_path / name))
    assert recs["torch"] == recs["jax"]
    assert files["torch"] == files["jax"]


@pytest.mark.parametrize("kind", ["full", "delta"])
def test_manifests_equal_as_bytes(kind, tmp_path):
    nodes = {i: {"key": f"families/step-8/node-{i}.reft", "nbytes": 1234,
                 "data_off": 77, "parts": 4, "upload_bytes": 1234,
                 "upload_s": 0.125 * i, "retries": i,
                 "crc_stripes": {"seg": 400, "crcs": [1, 2, 3]},
                 "crc_own": 99, "crc_parity": 4294967295,
                 **({"base_step": 4} if kind == "delta" else {})}
             for i in range(3)}
    blobs, views = {}, {}
    for name, pkg in PKGS.items():
        store = pkg.LocalObjectStore(str(tmp_path / name))
        man = pkg.build_manifest("run0", 8, 3, 3600, nodes)
        pkg.put_manifest(store, "families", man)
        store.put("families/step-9/node-0.reft", b"torn")
        blobs[name] = bytes(store.read(pkg.manifest_key("families", 8)))
        views[name] = (pkg.load_manifest(store, "families", 8),
                       pkg.object_families(store, "families"),
                       pkg.list_step_prefixes(store, "families"),
                       pkg.manifest_base_step(man))
    assert blobs["torch"] == blobs["jax"]
    assert views["torch"] == views["jax"]
    assert views["torch"][3] == (4 if kind == "delta" else None)


# ---------------------------------------------------------------- scrub
def _family_parts(n, bs, seed):
    """A RAIM5 family's shard regions, in numpy (the SMP's layout)."""
    total = n * (n - 1) * bs
    full = np.random.default_rng(seed).integers(0, 256, total, np.uint8)
    out = {}
    for node in range(n):
        own = np.concatenate([full[slice(*r.byte_range(bs, n))]
                              for r in raim5.data_blocks_of_node(node, n)])
        parity = raim5.encode_parity(node, n, full)
        out[node] = (own, parity,
                     [zlib.crc32(own[i * bs:(i + 1) * bs].tobytes())
                      for i in range(n - 1)],
                     zlib.crc32(parity.tobytes()))
    return total, out


def _local_family(d, n, bs, step, seed):
    total, parts = _family_parts(n, bs, seed)
    paths = {}
    for node, (own, parity, crcs, pcrc) in parts.items():
        head = {"node": node, "n": n, "total_bytes": total, "step": step,
                "meta": pickle.dumps({"crc_parity": pcrc}),
                "crc_stripes": {"seg": bs, "crcs": crcs}}
        paths[node] = os.path.join(d, f"step-{step}-node-{node}.reft")
        with open(paths[node], "wb") as f:
            f.write(pickle.dumps(head) + own.tobytes() + parity.tobytes())
    return paths


def _object_family(pkg, store, n, bs, step, seed):
    total, parts = _family_parts(n, bs, seed)
    nodes = {}
    for node, (own, parity, crcs, pcrc) in parts.items():
        head = pickle.dumps({"node": node, "n": n, "total_bytes": total,
                             "step": step, "meta": pickle.dumps({})})
        rec = pkg.upload_shard(store, pkg.shard_key("families", step, node),
                               head, np.concatenate([own, parity]), seg=bs,
                               own_bytes=own.nbytes)
        rec["upload_s"] = 0.0
        rec["crc_stripes"] = {"seg": bs, "crcs": crcs}
        rec["crc_parity"] = pcrc
        nodes[node] = rec
    pkg.put_manifest(store, "families",
                     pkg.build_manifest("run", step, n, total, nodes))


def _damage(path_or_store, data_off, off, pkg=None, key=None):
    junk = b"\xde\xad\xbe\xef"
    if pkg is None:
        with open(path_or_store, "r+b") as f:
            f.seek(data_off + off)
            f.write(junk)
    else:
        path_or_store.write_range(key, data_off + off, junk)


@pytest.mark.parametrize("where", ["data", "parity"])
@pytest.mark.parametrize("tier", ["file", "object"])
def test_scrub_detects_and_repairs_like_reference(tier, where, tmp_path):
    n, bs, step = 4, 512, 6
    node, off = (1, bs + 7) if where == "data" else (2, (n - 1) * bs + 100)
    reports, before, after = {}, {}, {}
    for name, pkg, sc in (("jax", J, jax_scrub), ("torch", T, torch_scrub)):
        d = str(tmp_path / name)
        os.makedirs(d)
        if tier == "file":
            paths = _local_family(d, n, bs, step, seed=3)
            before[name] = _tree_files(d)
            with open(paths[node], "rb") as f:
                pickle.load(f)
                data_off = f.tell()
            _damage(paths[node], data_off, off)
            reps = sc.scrub_local_dir(d) + sc.scrub_local_dir(d)
        else:
            store = pkg.LocalObjectStore(d)
            _object_family(pkg, store, n, bs, step, seed=3)
            before[name] = _tree_files(d)
            ent = pkg.load_manifest(store, "families", step)["nodes"][node]
            _damage(store, int(ent["data_off"]), off, pkg, ent["key"])
            reps = sc.scrub_object_store(store) + sc.scrub_object_store(store)
        reports[name] = [asdict(r) for r in reps]
        after[name] = _tree_files(d)
    assert reports["torch"] == reports["jax"]
    first, second = reports["torch"]
    want = f"node{node}:block1" if where == "data" else f"node{node}:parity"
    assert first["corrupt"] == [want] == first["repaired"]
    assert first["kind"] == tier and not first["unrepairable"]
    assert not second["corrupt"]                        # clean after repair
    assert after["torch"] == before["torch"] == before["jax"]


def test_scrubber_daemon_stats_match_reference(tmp_path):
    stats = {}
    for name, pkg in PKGS.items():
        d = str(tmp_path / name)
        os.makedirs(d)
        paths = _local_family(d, 3, 256, 2, seed=5)
        with open(paths[0], "rb") as f:
            pickle.load(f)
            data_off = f.tell()
        _damage(paths[0], data_off, 3)
        seen = []
        sc = pkg.Scrubber(ckpt_dir=d, interval_s=0.0, on_report=seen.append)
        sc.scan_once()
        st = sc.stats()
        st.pop("scrub_seconds")
        stats[name] = (st, [r.repaired for r in seen])
    assert stats["torch"] == stats["jax"]
    assert stats["torch"][0]["scrub_repaired"] == 1


# ------------------------------------------------------ backend e2e
def _numpy_state(seed=0):
    rng = np.random.default_rng(seed)
    import ml_dtypes
    return {"params": {"w": rng.standard_normal((61, 33)).astype(np.float32),
                       "e": rng.standard_normal(2049)
                       .astype(ml_dtypes.bfloat16)},
            "opt_state": {"mu": {"w": rng.standard_normal((61, 33))
                                 .astype(np.float32)}},
            "rng": np.asarray([0, 12345], np.uint32),
            "step": np.asarray(7, np.int32)}


def _persist_family(create, spec_cls, root, state, run_id):
    spec = spec_cls(backend="objstore", ckpt_dir=str(root), sg_size=2,
                    run_id=run_id, options={"scrub_every_s": 0.0})
    ck = create(spec, state)
    try:
        assert ck.snapshot(state, 7, extra_meta={"ds": 3}, wait=True)
        assert ck.persist(wait=True) == 7
        assert ck.stats()["persist_upload_bytes"] > 0
    finally:
        ck.close()


def test_objstore_backend_bytes_and_cross_restores(tmp_path):
    tree = _numpy_state()
    jstate = jax.tree_util.tree_map(jnp.asarray, tree)
    tstate = convert.state_from_numpy(tree, "cpu")
    _persist_family(jax_create, JaxSpec, tmp_path / "jax", jstate, "cmp0")
    _persist_family(create_checkpointer, CheckpointSpec, tmp_path / "torch",
                    tstate, "cmp0")
    jfiles, tfiles = (_tree_files(str(tmp_path / n)) for n in ("jax", "torch"))
    assert sorted(tfiles) == sorted(jfiles)
    man_key = os.path.join("objstore", "families", "step-7", "MANIFEST.json")
    for name in tfiles:
        if name != man_key:                      # .reft files and shards
            assert tfiles[name] == jfiles[name], name
    jm, tm = (json.loads(f[man_key]) for f in (jfiles, tfiles))
    for m in (jm, tm):
        for rec in m["nodes"].values():
            rec.pop("upload_s")                  # wall-clock seconds
    assert tm == jm

    want = np.concatenate([host_bytes(x) for x in leaf_arrays(tstate)])
    # each package restores the other's remote family
    got, step, extra = restore_from_objstore(
        J.LocalObjectStore(str(tmp_path / "jax" / "objstore")), "families",
        2, tstate)
    assert step == 7 and extra == {"ds": 3}
    assert np.array_equal(
        np.concatenate([host_bytes(x) for x in leaf_arrays(got)]), want)
    jgot, jstep, _ = jax_restore_obj(
        T.LocalObjectStore(str(tmp_path / "torch" / "objstore")), "families",
        2, jstate)
    assert jstep == 7
    jflat = np.concatenate([np.ascontiguousarray(np.asarray(x)).reshape(-1)
                            .view(np.uint8) for x in jax_leaf_arrays(jgot)])
    assert np.array_equal(jflat, want)
