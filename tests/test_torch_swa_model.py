"""The port's sliding-window archs against the JAX package's, on
JAX-initialised weights carried across by `repro_torch.convert` and the
same batch: reduced starcoder2-3b (window 64 in both layers) and reduced
gemma3-4b (window 64, local and global layers alternating, qk-norm,
chunked cross-entropy), float32, at S = 2048 so that the flash branch
(`kernels.swa_attention.swa_flash`, its plain version on the CPU) runs.

Tolerances as tests/test_torch_model.py states them: the loss rtol 1e-5,
the gradients rtol 1e-4 (atol 1e-6): the same float32 math, summed in
another order. The bf16 train state's flat stream (spec JSON and bytes)
is identical to the reference's."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config
from repro.configs.base import InputShape as JaxShape
from repro.core import treebytes as jtb
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import model as JM
from repro.train.steps import init_train_state as jax_init_train_state
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape
from repro_torch.core import treebytes as ttb
from repro_torch.core.treebytes import leaf_arrays, tree_flatten_with_path
from repro_torch.data.pipeline import make_batch
from repro_torch.models import model as TM
from repro_torch.models.layers import FULL_WINDOW
from repro_torch.train import steps as tsteps

# the package names the public function `swa_attention`, as the reference
# does
KS = importlib.import_module("repro_torch.kernels.swa_attention")

ARCHS = ["starcoder2-3b", "gemma3-4b"]
SEQ = 2048


def _cfgs(arch, **kw):
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(tget(arch).reduced(), **kw)
    return cfg, tcfg


def _setup(arch, seq, **kw):
    cfg, tcfg = _cfgs(arch, **kw)
    jstate = jax_init_train_state(cfg, 0).tree()
    jbatch = jax_make_batch(cfg, JaxShape("t", seq, 1, "train"), seed=3)
    tbatch = make_batch(tcfg, InputShape("t", seq, 1, "train"), seed=3,
                        device="cpu")
    for k in jbatch:
        assert np.array_equal(np.asarray(jbatch[k]), tbatch[k].numpy())
    return cfg, tcfg, jstate["params"], jbatch, tbatch


def test_window_array_matches_reference():
    for arch in ARCHS:
        for cut in (lambda c: c, lambda c: c.reduced()):
            cfg, tcfg = cut(get_config(arch)), cut(tget(arch))
            assert TM.window_array(tcfg) == \
                np.asarray(JM.window_array(cfg)).tolist()
    assert TM.window_array(tget("starcoder2-3b")) == [4096] * 30
    g = TM.window_array(tget("gemma3-4b"))
    assert g[:6] == [1024] * 5 + [FULL_WINDOW] and len(g) == 34
    assert TM.window_array(tget("gemma3-4b").reduced()) == [64, FULL_WINDOW]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    cfg, tcfg, jparams, jbatch, tbatch = _setup(arch, SEQ)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.forward(cfg, p, jbatch)[0])(jparams)
    windows = []
    plain = KS.swa_flash_plain

    def spy(q, k, v, *, window, causal=True):
        windows.append(window)
        return plain(q, k, v, window=window, causal=causal)

    monkeypatch.setattr(KS, "swa_flash_plain", spy)
    tparams = convert.state_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = [p.requires_grad_(True) for p in leaf_arrays(tparams)]
    tloss, _ = TM.forward(tcfg, tparams, tbatch)
    tgrads = torch.autograd.grad(tloss, leaves)
    assert windows == TM.window_array(tcfg)        # every layer: flash
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    paths = [p for p, _ in tree_flatten_with_path(tparams)]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == paths
    for path, (_, jg), tg in zip(paths, jflat, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6, err_msg=path)


def test_banded_attention_takes_the_flash_path_as_the_reference():
    """`banded_attention` sends a short sequence down the flash path with
    the layer's window as its static band, as the reference does; the
    loss is the reference's (and the masked softmax's)."""
    cfg, tcfg, jparams, jbatch, tbatch = _setup(
        "starcoder2-3b", 256, banded_attention=True)
    jloss = JM.forward(cfg, jparams, jbatch)[0]
    tparams = convert.state_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    banded = TM.forward(tcfg, tparams, tbatch)[0]
    np.testing.assert_allclose(banded.item(), float(jloss), rtol=1e-5)
    masked = TM.forward(dataclasses.replace(tcfg, banded_attention=False),
                        tparams, tbatch)[0]
    np.testing.assert_allclose(banded.item(), masked.item(), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_state_stream_matches_reference(arch):
    cfg, tcfg = _cfgs(arch, dtype="bfloat16", param_dtype="bfloat16")
    jstate = jax.tree.map(np.asarray, jax_init_train_state(cfg, 0).tree())
    tstate = convert.state_from_numpy(jstate, device="cpu")
    jspec, tspec = jtb.make_flat_spec(jstate), ttb.make_flat_spec(tstate)
    assert tspec.to_json() == jspec.to_json()
    jbuf = np.zeros(jspec.total_bytes, np.uint8)
    tbuf = np.zeros(tspec.total_bytes, np.uint8)
    jtb.tree_to_buffer(jstate, jspec, jbuf)
    ttb.tree_to_buffer(tstate, tspec, tbuf)
    assert np.array_equal(jbuf, tbuf)
    own = tsteps.init_train_state(tcfg, 0, device="cpu")
    assert ttb.make_flat_spec(own).to_json() == jspec.to_json()
