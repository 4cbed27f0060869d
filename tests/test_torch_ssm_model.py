"""The port's Mamba2 (SSM family) against the JAX package's, on
JAX-initialised weights carried across by `repro_torch.convert` and the
same batch (reduced mamba2-130m, float32; the SSD chunk is cut to 16 in
both packages so a 64-token sequence carries state over 4 chunks).

Tolerances: `ssm_block`'s output, final state and conv state rtol 1e-5
with atol 1e-5 of the largest magnitude (an output near zero sums terms
of the block's full size; see tests/test_torch_ssd.py), the loss rtol
1e-5, the gradients rtol 1e-4 (atol 1e-6) as in
tests/test_torch_model.py: the same float32 math, summed in another
order. The train state's flat stream (spec JSON and bytes) is identical,
for fp32 params and for bf16 params with the fp32 `A_log`, `dt_bias` and
`D_skip` leaves among them."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config
from repro.configs.base import InputShape as JaxShape
from repro.core import treebytes as jtb
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import model as JM
from repro.models.ssm import ssm_block as jax_ssm_block
from repro.train.steps import init_train_state as jax_init_train_state
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape
from repro_torch.core import treebytes as ttb
from repro_torch.core.treebytes import leaf_arrays, tree_flatten_with_path
from repro_torch.data.pipeline import make_batch
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.train import steps as tsteps

CHUNK = 16
SEQ = 64


def _cfgs(dtype="float32"):
    kw = dict(ssd_chunk=CHUNK)
    if dtype != "float32":
        kw.update(dtype=dtype, param_dtype=dtype)
    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(), **kw)
    tcfg = dataclasses.replace(tget("mamba2-130m").reduced(), **kw)
    return cfg, tcfg


@pytest.fixture(scope="module")
def setup():
    cfg, tcfg = _cfgs()
    jstate = jax_init_train_state(cfg, 0).tree()
    np_params = jax.tree.map(np.asarray, jstate["params"])
    jbatch = jax_make_batch(cfg, JaxShape("t", SEQ, 2, "train"), seed=3)
    tbatch = make_batch(tcfg, InputShape("t", SEQ, 2, "train"), seed=3,
                        device="cpu")
    for k in jbatch:
        assert np.array_equal(np.asarray(jbatch[k]), tbatch[k].numpy())
    return cfg, tcfg, jstate["params"], np_params, jbatch, tbatch


def test_ssm_block_matches_reference(setup):
    cfg, tcfg, jparams, np_params, _, _ = setup
    layer0 = jax.tree.map(lambda x: x[0], jparams["blocks"]["pos0"]["mix"])
    x = np.random.default_rng(0).standard_normal(
        (2, SEQ, cfg.d_model)).astype(np.float32)
    jout, (jconv, jh) = jax_ssm_block(layer0, cfg, x, chunk=CHUNK)
    tp = convert.state_from_numpy(jax.tree.map(np.asarray, layer0), "cpu")
    tout, (tconv, th) = TS.ssm_block(tp, tcfg, torch.from_numpy(x),
                                     chunk=CHUNK)
    for got, want in ((tout, jout), (th, jh), (tconv, jconv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_loss_and_grads_match_reference(setup):
    cfg, tcfg, jparams, np_params, jbatch, tbatch = setup
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.forward(cfg, p, jbatch)[0])(jparams)
    tparams = convert.state_from_numpy(np_params, device="cpu")
    assert "lm_head" not in tparams                   # tied head
    assert set(tparams["blocks"]["pos0"]) == {"ln1", "mix"}    # no FFN
    leaves = [p.requires_grad_(True) for p in leaf_arrays(tparams)]
    tloss, _ = TM.forward(tcfg, tparams, tbatch)
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    paths = [p for p, _ in tree_flatten_with_path(tparams)]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == paths
    for path, (_, jg), tg in zip(paths, jflat, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6, err_msg=path)


def test_remat_does_not_change_loss_or_grads(setup):
    _, tcfg, _, np_params, _, tbatch = setup
    out = []
    for remat in (False, True):
        tparams = convert.state_from_numpy(np_params, device="cpu")
        leaves = [p.requires_grad_(True) for p in leaf_arrays(tparams)]
        loss, _ = TM.forward(tcfg, tparams, tbatch, remat=remat)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    paths = [p for p, _ in tree_flatten_with_path(tparams)]
    for path, a, b in zip(paths, out[0][1], out[1][1]):
        if path == "['embed']":
            # tied: the head's and the lookup's contributions are summed
            # in whichever order autograd reaches them, so an element may
            # move by an ulp of the contributions, of the leaf's scale
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6 * a.abs().max().item())
        else:
            assert torch.equal(a, b), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_state_stream_matches_reference(dtype):
    cfg, tcfg = _cfgs(dtype)
    jstate = jax.tree.map(np.asarray, jax_init_train_state(cfg, 0).tree())
    tstate = convert.state_from_numpy(jstate, device="cpu")
    jspec, tspec = jtb.make_flat_spec(jstate), ttb.make_flat_spec(tstate)
    assert tspec.to_json() == jspec.to_json()
    fp32 = {l.path for l in tspec.leaves if l.dtype == "float32"
            and l.path.startswith("['params']")}
    mix = "['params']['blocks']['pos0']['mix']"
    assert {f"{mix}['{k}']" for k in ("A_log", "dt_bias", "D_skip")} <= fp32
    if dtype == "bfloat16":
        assert len(fp32) == 3
    jbuf = np.zeros(jspec.total_bytes, np.uint8)
    tbuf = np.zeros(tspec.total_bytes, np.uint8)
    jtb.tree_to_buffer(jstate, jspec, jbuf)
    ttb.tree_to_buffer(tstate, tspec, tbuf)
    assert np.array_equal(jbuf, tbuf)
    # the port's own fresh state has the same layout (values differ)
    own = tsteps.init_train_state(tcfg, 0, device="cpu")
    assert ttb.make_flat_spec(own).to_json() == jspec.to_json()


def test_port_trains_mamba2_a_few_steps():
    _, tcfg = _cfgs()
    state = tsteps.init_train_state(tcfg, 0, device="cpu")
    step_fn = tsteps.make_train_step(tcfg)
    batch = make_batch(tcfg, InputShape("t", SEQ, 2, "train"), seed=0,
                       device="cpu")
    losses = []
    for _ in range(3):
        state, m = step_fn(state, batch)
        losses.append(m["loss"].item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert state["params"]["blocks"]["pos0"]["mix"]["A_log"].dtype \
        == torch.float32


def test_grads_stay_finite_where_the_reference_is_nan():
    """At the reduced model's own chunk (256) and seq 128 the reference's
    `ssd_chunked` overflows exp in its masked triangle and its gradients
    go NaN; the port's stay finite (it masks before the exp)."""
    cfg, tcfg = (c.reduced() for c in (get_config("mamba2-130m"),
                                       tget("mamba2-130m")))
    jstate = jax_init_train_state(cfg, 0).tree()
    jbatch = jax_make_batch(cfg, JaxShape("t", 128, 2, "train"), seed=3)
    _, jgrads = jax.value_and_grad(
        lambda p: JM.forward(cfg, p, jbatch)[0])(jstate["params"])
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(jgrads))
    tparams = convert.state_from_numpy(
        jax.tree.map(np.asarray, jstate["params"]), device="cpu")
    tbatch = make_batch(tcfg, InputShape("t", 128, 2, "train"), seed=3,
                        device="cpu")
    leaves = [p.requires_grad_(True) for p in leaf_arrays(tparams)]
    tloss, _ = TM.forward(tcfg, tparams, tbatch)
    assert all(torch.isfinite(g).all()
               for g in torch.autograd.grad(tloss, leaves))
