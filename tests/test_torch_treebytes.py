"""The port's flat byte stream equals the JAX package's, byte for byte:
leaf order, keystr paths, dtype names, treedef string, and the bytes."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.core import treebytes as jtb
from repro.train.steps import init_train_state as jax_init_train_state
from repro_torch import convert
from repro_torch.core import treebytes as ttb


def _opt_state(dtype: str):
    cfg = get_config("opt-125m").reduced()
    if dtype != "float32":
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    jstate = jax.tree.map(np.asarray, jax_init_train_state(cfg, 0).tree())
    return jstate, convert.state_from_numpy(jstate, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_state_stream_matches_reference(dtype):
    jstate, tstate = _opt_state(dtype)
    jspec, tspec = jtb.make_flat_spec(jstate), ttb.make_flat_spec(tstate)
    assert tspec.to_json() == jspec.to_json()
    dtypes = {l.dtype for l in tspec.leaves}
    assert {dtype, "uint32", "int32"} <= dtypes
    scalars = [l for l in tspec.leaves if l.shape == ()]
    assert scalars and all(l.nbytes == 4 for l in scalars)
    jbuf = np.zeros(jspec.total_bytes, np.uint8)
    tbuf = np.zeros(tspec.total_bytes, np.uint8)
    jtb.tree_to_buffer(jstate, jspec, jbuf)
    ttb.tree_to_buffer(tstate, tspec, tbuf)
    assert np.array_equal(jbuf, tbuf)
    # partial ranges compose the same way
    lo, hi = 1234, tspec.total_bytes - 77
    part = np.zeros(hi - lo, np.uint8)
    ttb.tree_to_buffer(tstate, tspec, part, lo, hi)
    assert np.array_equal(part, jbuf[lo:hi])
    # and the buffer rebuilds the port's tree exactly
    back = ttb.buffer_to_tree(tstate, tspec, tbuf)
    for a, b in zip(ttb.leaf_arrays(tstate), ttb.leaf_arrays(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ttb.state_crc(tstate) == ttb.crc32_of(tbuf)


def test_structure_strings_match_jax():
    """Sorted dict keys, lists, tuples (incl. 1-tuples), None, scalars."""
    tree = {"zeta": [np.zeros(3, np.float32), (np.int32(1),)],
            "alpha": {"b": np.ones((2, 2), np.int64), "a": None},
            "mid": (np.zeros((), np.bool_), np.arange(4, dtype=np.uint8))}
    ttree = convert.state_from_numpy(tree, device="cpu")
    assert ttb.treedef_repr(ttree) == \
        str(jax.tree_util.tree_structure(tree))
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [p for p, _ in ttb.tree_flatten_with_path(ttree)] == jpaths
    assert ttb.make_flat_spec(ttree).to_json() == \
        jtb.make_flat_spec(tree).to_json()


def test_bfloat16_bits_cross_exactly():
    x = jnp.asarray(np.linspace(-3, 3, 37), jnp.bfloat16)
    t = convert.tensor_from_numpy(np.asarray(x), device="cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(ttb.host_bytes(t), np.asarray(x).view(np.uint8))
