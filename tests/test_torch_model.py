"""The port's model, optimizer and RNG leaf against the JAX package's, on
JAX-initialised weights carried across by `repro_torch.convert` and the
same batch (reduced opt-125m, float32).

Tolerances: the loss agrees to rtol 1e-5 and the gradients to rtol 1e-4
(atol 1e-6) — both run the same float32 math, summed in another order.
Adam is compared on GIVEN gradients (rtol 1e-6): after a full step,
Adam's first update maps tiny gradients to +-lr, so a sign flip in a
near-zero gradient would be noise, not a fault.  Its atol of 1e-9 covers
moments that cancel to ~1e-6 from terms of order 1e-2, whose float32
rounding (and the last-ulp difference of the clip factor, a norm summed
in another order) is of that size.  `fold_in` is exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.configs.base import InputShape as JaxShape
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import model as JM
from repro.models.flash import flash_attention as jax_flash
from repro.optim.adam import AdamConfig as JaxAdamConfig
from repro.optim.adam import adam_update as jax_adam_update
from repro.train.steps import init_train_state as jax_init_train_state
from repro_torch import convert
from repro_torch.configs.base import InputShape
from repro_torch.core.treebytes import leaf_arrays, tree_flatten_with_path
from repro_torch.data.pipeline import make_batch
from repro_torch.models import model as TM
from repro_torch.models.flash import flash_attention
from repro_torch.optim.adam import AdamConfig, adam_update
from repro_torch.train import steps as tsteps


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("opt-125m").reduced()
    from repro_torch.configs import get_config as tget
    tcfg = tget("opt-125m").reduced()
    jstate = jax_init_train_state(cfg, 0).tree()
    np_params = jax.tree.map(np.asarray, jstate["params"])
    jbatch = jax_make_batch(cfg, JaxShape("t", 32, 2, "train"), seed=3)
    tbatch = make_batch(tcfg, InputShape("t", 32, 2, "train"), seed=3,
                        device="cpu")
    for k in jbatch:
        assert np.array_equal(np.asarray(jbatch[k]), tbatch[k].numpy())
    return cfg, tcfg, jstate["params"], np_params, jbatch, tbatch


def test_loss_and_grads_match_reference(setup):
    cfg, tcfg, jparams, np_params, jbatch, tbatch = setup
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.forward(cfg, p, jbatch)[0])(jparams)
    tparams = convert.state_from_numpy(np_params, device="cpu")
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


def test_remat_does_not_change_the_loss(setup):
    _, tcfg, _, np_params, _, tbatch = setup
    tparams = convert.state_from_numpy(np_params, device="cpu")
    a, _ = TM.forward(tcfg, tparams, tbatch, remat=False)
    b, _ = TM.forward(tcfg, tparams, tbatch, remat=True)
    assert torch.equal(a, b)


def test_adam_update_on_given_grads_matches_reference(setup):
    _, _, jparams, np_params, _, _ = setup
    rng = np.random.default_rng(5)
    np_grads = jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.3).astype(np.float32),
        np_params)
    np_opt = {"mu": jax.tree.map(lambda p: rng.standard_normal(p.shape)
                                 .astype(np.float32) * 0.01, np_params),
              "nu": jax.tree.map(lambda p: rng.random(p.shape)
                                 .astype(np.float32) * 1e-3, np_params),
              "step": np.asarray(4, np.int32)}
    jp, jo, jn = jax_adam_update(JaxAdamConfig(),
                                 jax.tree.map(jnp.asarray, np_grads),
                                 jax.tree.map(jnp.asarray, np_opt), jparams)
    tp, to, tn = adam_update(AdamConfig(),
                             convert.state_from_numpy(np_grads, "cpu"),
                             convert.state_from_numpy(np_opt, "cpu"),
                             convert.state_from_numpy(np_params, "cpu"))
    assert float(jn) > 1.0                       # the clip is active
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    for a, b in zip(leaf_arrays(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)
    for key in ("mu", "nu"):
        for a, b in zip(leaf_arrays(to[key]), jax.tree.leaves(jo[key])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)
    assert int(to["step"]) == int(jo["step"]) == 5


def test_adam_update_is_out_of_place(setup):
    _, _, _, np_params, _, _ = setup
    params = convert.state_from_numpy(np_params, "cpu")
    before = [p.clone() for p in leaf_arrays(params)]
    grads = {k: v for k, v in params.items()}
    opt = tsteps.adam_init(params)
    adam_update(AdamConfig(), grads, opt, params)
    assert all(torch.equal(a, b) for a, b in zip(before, leaf_arrays(params)))
    assert not any(x.any() for x in leaf_arrays(opt["mu"]))


@pytest.mark.parametrize("seed,data", [(1, 0), (1, 7), (0, 2 ** 31 + 5),
                                       (123456789, 99)])
def test_fold_in_matches_jax_exactly(seed, data):
    jkey = jax.random.PRNGKey(seed)
    assert np.array_equal(tsteps.prng_key(seed), np.asarray(jkey))
    want = np.asarray(jax.random.fold_in(jkey, jnp.uint32(data)))
    assert np.array_equal(tsteps.fold_in(np.asarray(jkey), data), want)


def test_train_step_advances_rng_like_the_reference(setup):
    _, tcfg, _, _, _, tbatch = setup
    state = tsteps.init_train_state(tcfg, 0, device="cpu")
    assert np.array_equal(state["rng"].numpy(),
                          np.asarray(jax.random.PRNGKey(1)))
    step_fn = tsteps.make_train_step(tcfg)
    key = jax.random.PRNGKey(1)
    for i in range(2):
        state, metrics = step_fn(state, tbatch)
        key = jax.random.fold_in(key, jnp.int32(i))
        assert np.array_equal(state["rng"].numpy(), np.asarray(key))
        assert int(state["step"]) == int(state["opt_state"]["step"]) == i + 1
        assert np.isfinite(metrics["loss"].item())


def test_flash_attention_matches_reference():
    rng = np.random.default_rng(0)
    B, S, KV, G, hd = 2, 64, 2, 2, 16
    q = rng.standard_normal((B, S, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    for window, causal in ((1 << 30, True), (24, True), (24, False)):
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         window=window, causal=causal, block_q=16,
                         block_k=16)
        got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window,
                              causal=causal, block_q=16, block_k=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_unported_families_say_where_they_wait():
    import dataclasses
    from repro_torch.configs import get_config as tget
    # dense (full and sliding-window attention), MoE, SSM, hybrid, VLM and
    # audio inputs: ported
    for name in ("opt-125m", "mamba2-130m", "starcoder2-3b", "gemma3-4b",
                 "phi-3-vision-4.2b", "hubert-xlarge", "dbrx-132b",
                 "kimi-k2-1t-a32b", "jamba-v0.1-52b"):
        TM.check_supported(tget(name))
        TM.check_supported(tget(name).reduced())
    # a family outside the reference's still raises, naming it
    odd = dataclasses.replace(tget("opt-125m").reduced(), family="retention")
    with pytest.raises(NotImplementedError, match="ported are") as e:
        TM.check_supported(odd)
    assert "'retention' is unknown" in str(e.value)
