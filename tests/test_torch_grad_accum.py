"""Gradient accumulation in the port's train step against the JAX
package's (tests/test_grad_accum.py's cases), and the step factories the
reference's `repro.train` exports.

`make_train_step(cfg, microbatches=k)` on the reference's state carried
across by `repro_torch.convert` and the same batch: the loss and every
new parameter against the reference's `make_train_step(cfg,
microbatches=k)` (the same float32 math, summed in another order: loss
rtol 1e-5, params atol 2e-5 and rtol 2e-4, the tolerance the reference
holds its own microbatched step to) and against the port's own
full-batch step (the same tolerances: equal chunks average to the
full-batch gradient). The steps take AdamW with eps 1e-3 (`OPT`): at the
default 1e-8 the first update is lr * g / |g|, whose sign flips for a
gradient within 1e-8 of zero when two summation orders differ in its
last digits, which is no fault of the accumulation; at 1e-3 the update
is a smooth function of the gradient, and the parameters show how close
the two accumulations are. An indivisible batch is refused (a
ValueError; the reference's assert refuses it)."""
import numpy as np
import pytest
import jax

from repro.configs import get_config
from repro.configs.base import InputShape as JaxShape
from repro.data.pipeline import make_batch as jax_make_batch
from repro.optim.adam import AdamConfig as JaxAdam
from repro.train import steps as jsteps
from repro_torch import convert, train as ttrain
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape
from repro_torch.core.treebytes import leaf_arrays
from repro_torch.data.pipeline import make_batch
from repro_torch.models import model as TM
from repro_torch.optim.adam import AdamConfig
from repro_torch.train import steps as tsteps

SHAPE = ("t", 32, 4, "train")        # tests/test_grad_accum.py's
OPT = dict(eps=1e-3)


def _setup(arch, shape=SHAPE, seed=3):
    cfg, tcfg = get_config(arch).reduced(), tget(arch).reduced()
    jstate = jsteps.init_train_state(cfg, 0).tree()
    jbatch = jax_make_batch(cfg, JaxShape(*shape), seed=seed)
    tbatch = make_batch(tcfg, InputShape(*shape), seed=seed, device="cpu")
    tstate = convert.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    return cfg, tcfg, jstate, jbatch, tstate, tbatch


def _close(a_tree, b_tree, **tol):
    for a, b in zip(leaf_arrays(a_tree), leaf_arrays(b_tree)):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), **tol)


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-130m"])
@pytest.mark.parametrize("k", [2, 4])
def test_microbatch_matches_reference_and_full_batch(arch, k):
    cfg, tcfg, jstate, jbatch, tstate, tbatch = _setup(arch)
    j_mb, jm = jax.jit(jsteps.make_train_step(cfg, JaxAdam(**OPT),
                                              microbatches=k))(jstate, jbatch)
    t_mb, tm = tsteps.make_train_step(tcfg, AdamConfig(**OPT),
                                      microbatches=k)(tstate, tbatch)
    t_full, tf = tsteps.make_train_step(tcfg, AdamConfig(**OPT))(tstate,
                                                                 tbatch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["loss"]), float(tf["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    tol = dict(atol=2e-5, rtol=2e-4)
    _close([t.numpy() for t in leaf_arrays(t_mb["params"])],
           jax.tree.leaves(j_mb["params"]), **tol)
    _close([t.numpy() for t in leaf_arrays(t_mb["params"])],
           [t.numpy() for t in leaf_arrays(t_full["params"])], **tol)
    assert int(t_mb["step"]) == int(j_mb["step"]) == 1
    assert np.array_equal(t_mb["rng"].numpy(), np.asarray(j_mb["rng"]))
    # out of place: the state given is untouched
    for a, b in zip(leaf_arrays(tstate["params"]),
                    jax.tree.leaves(jstate["params"])):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_microbatch_requires_divisible_batch():
    _, tcfg, _, _, tstate, tbatch = _setup("qwen3-8b", ("t", 16, 3, "train"),
                                           seed=1)
    with pytest.raises(ValueError, match="does not split into 2"):
        tsteps.make_train_step(tcfg, microbatches=2)(tstate, tbatch)


def test_microbatches_split_every_batch_entry():
    """A VLM batch (patches, tokens, labels) splits on axis 0 like the
    reference's `jax.tree.map(split, batch)`: the accumulated step equals
    the full-batch one."""
    tcfg = tget("phi-3-vision-4.2b").reduced()
    state = tsteps.init_train_state(tcfg, 0, device="cpu")
    batch = make_batch(tcfg, InputShape("t", 24, 4, "train"), device="cpu")
    a, ma = tsteps.make_train_step(tcfg, AdamConfig(**OPT),
                                   microbatches=2)(state, batch)
    b, mb = tsteps.make_train_step(tcfg, AdamConfig(**OPT))(state, batch)
    np.testing.assert_allclose(float(ma["loss"]), float(mb["loss"]),
                               rtol=1e-5)
    _close([t.numpy() for t in leaf_arrays(a["params"])],
           [t.numpy() for t in leaf_arrays(b["params"])], atol=2e-5,
           rtol=2e-4)


def test_api_twins_match_reference():
    """`repro_torch.train` exports the reference's names; `TrainState`
    round-trips the tree; the eval, prefill and decode factories give
    the reference's values (atol 2e-4, rtol 2e-3, the decode tolerance
    of tests/test_torch_decode.py)."""
    from repro import train as jtrain
    assert ttrain.__all__ == jtrain.__all__
    cfg, tcfg, jstate, jbatch, tstate, tbatch = _setup("qwen3-8b",
                                                       ("t", 16, 2, "train"))
    ts = ttrain.TrainState.from_tree(tstate)
    assert all(ts.tree()[k] is tstate[k] for k in tstate)
    assert sorted(ts.tree()) == sorted(tstate)
    tol = dict(atol=2e-4, rtol=2e-3)
    jp, tp = jstate["params"], tstate["params"]
    np.testing.assert_allclose(
        float(tsteps.make_eval_step(tcfg)(tp, tbatch)),
        float(jsteps.make_eval_step(cfg)(jp, jbatch)), rtol=1e-5)
    tl, _ = ttrain.make_prefill_step(tcfg)(tp, tbatch)
    jl, _ = jsteps.make_prefill_step(cfg)(jp, jbatch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    tcache = TM.init_cache(tcfg, 2, 4, "cpu")
    jcache = jsteps.M.init_cache(cfg, 2, 4)
    tok = tbatch["tokens"][:, :1]
    tlg, tcache = ttrain.make_decode_step(tcfg)(tp, tcache, tok)
    jlg, jcache = jsteps.make_decode_step(cfg)(jp, jcache,
                                               jbatch["tokens"][:, :1])
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **tol)
    assert int(tcache["index"]) == int(jcache["index"]) == 1
