"""The port's VLM and audio inputs against the JAX package's, on the CPU:
reduced phi-3-vision-4.2b (patch embeddings through `proj_in` before the
tokens, the loss masked over the patches) and reduced hubert-xlarge
(frame embeddings through `proj_in`, an encoder: non-causal attention,
no token embedding, its own head), each also with `head_dim` 80, 96 and
112 (the padded widths of the `swa_flash` kernels), float32, on
JAX-initialised weights carried across by `repro_torch.convert` and the
same batch.

Tolerances: the loss rtol 1e-5 and every gradient rtol 1e-4, atol 1e-6
(tests/test_torch_model.py's: the same float32 math, summed in another
order); `logits_fn`, its caches and `decode_step` atol 2e-4, rtol 2e-3
(tests/test_torch_decode.py's, the reference's own for decode against
the forward); the plain `swa_flash` at the padded widths against the
reference's Pallas kernel (interpret mode) and its `flash_attention`
atol 2e-5, rtol 1e-4 (tests/test_kernels.py's sweep tolerance). Batches
are bit-equal to the reference's, and the bf16 train state's flat stream
byte-equal."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.configs.base import InputShape as JaxShape
from repro.core import treebytes as jtb
from repro.data.pipeline import make_batch as jax_make_batch
from repro.kernels.swa_attention import swa_flash as jax_swa_flash
from repro.models import model as JM
from repro.models.flash import flash_attention as jax_flash
from repro.train.steps import init_train_state as jax_init_train_state
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import InputShape
from repro_torch.core import treebytes as ttb
from repro_torch.core.treebytes import leaf_arrays, tree_flatten_with_path
from repro_torch.data.pipeline import make_batch, make_batch_numpy
from repro_torch.models import model as TM
from repro_torch.models.layers import FULL_WINDOW
from repro_torch.train import steps as tsteps

VLM, AUDIO = "phi-3-vision-4.2b", "hubert-xlarge"
ARCHS = [VLM, AUDIO]
# the package names the public function `swa_attention`, as the reference
# does
KS = importlib.import_module("repro_torch.kernels.swa_attention")
PADDED = (80, 96, 112)
FLASH = 2048                       # models.attention.FLASH_THRESHOLD
TOL = dict(atol=2e-4, rtol=2e-3)


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(tget(arch).reduced(), **kw))


def _batches(cfg, tcfg, seq, batch=1, kind="train", seed=3):
    jb = jax_make_batch(cfg, JaxShape("t", seq, batch, kind), seed=seed)
    tb = make_batch(tcfg, InputShape("t", seq, batch, kind), seed=seed,
                    device="cpu")
    return jb, tb


def _bits(x):
    """The raw bytes of a JAX array or a tensor, as a flat uint8 array."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.uint8).numpy().ravel() if x.element_size() > 1 \
            else x.numpy().view(np.uint8).ravel()
    a = np.asarray(x)
    return a.view(np.uint8).ravel()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kind", [(VLM, "train"), (VLM, "prefill"),
                                       (AUDIO, "train"), (VLM, "decode")])
def test_batches_are_bit_equal(arch, kind, dtype):
    """`make_batch` draws the reference's values in its key order
    (patches before tokens, frames without tokens) and casts them as
    `jnp.asarray(x, dtype)` does: float64 to float32, then to bfloat16."""
    cfg, tcfg = _cfgs(arch, dtype=dtype)
    jb, tb = _batches(cfg, tcfg, 48, batch=2, kind=kind, seed=7)
    assert list(tb) == list(jb)
    want = {"decode": ["tokens"], "train": (
        ["patches", "tokens", "labels"] if arch == VLM
        else ["frames", "labels"])}
    assert list(tb) == want.get(kind, want["train"])
    for k in jb:
        assert tuple(tb[k].shape) == jb[k].shape, k
        assert str(tb[k].dtype)[6:] == str(jb[k].dtype), k
        assert np.array_equal(_bits(tb[k]), _bits(jb[k])), k
    if arch == VLM and kind != "decode":
        assert tb["tokens"].shape[1] == 48 - cfg.num_patches
    host = make_batch_numpy(tcfg, InputShape("t", 48, 2, kind), seed=7)
    for k, v in host.items():
        assert v.dtype == (np.int32 if jb[k].dtype == jnp.int32
                           else np.float32), k


def test_batches_of_the_full_configs_match_in_bf16():
    """The full configs' shapes (bf16 embeddings of d_model 3072 and
    1280), a short sequence: bit-equal, and the patches' rounding goes
    through float32 as the reference's (a value just above a bf16
    halfway point would round up in one step)."""
    for arch in ARCHS:
        cfg, tcfg = get_config(arch), tget(arch)
        seq = cfg.num_patches + 8 if arch == VLM else 8
        jb, tb = _batches(cfg, tcfg, seq, seed=11)
        for k in jb:
            assert np.array_equal(_bits(tb[k]), _bits(jb[k])), (arch, k)
    x = np.array([1 + 2 ** -8 + 2 ** -40])
    one = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    assert np.array_equal(_bits(one), _bits(jnp.asarray(x, jnp.bfloat16)))
    assert one.item() == 1.0


def _grad_cases():
    cases = []
    for arch in ARCHS:
        for hd in (None, *PADDED):
            cases.append((arch, hd, 40))
    # the flash path (S >= the threshold) at each model's own width:
    # hubert non-causal at 80, phi-3-vision causal at 96
    cases += [(AUDIO, 80, FLASH), (VLM, 96, FLASH)]
    return cases


@pytest.mark.parametrize("arch,hd,seq", _grad_cases())
def test_loss_and_grads_match_reference(arch, hd, seq):
    kw = {} if hd is None else {"head_dim": hd}
    cfg, tcfg = _cfgs(arch, **kw)
    assert tcfg.causal is (arch == VLM)
    jparams = jax_init_train_state(cfg, 0).tree()["params"]
    jb, tb = _batches(cfg, tcfg, seq)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.forward(cfg, p, jb)[0])(jparams)
    tparams = convert.state_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    leaves = [p.requires_grad_(True) for p in leaf_arrays(tparams)]
    tloss, _ = TM.forward(tcfg, tparams, tb)
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    paths = [p for p, _ in tree_flatten_with_path(tparams)]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == paths
    for path, (_, jg), tg in zip(paths, jflat, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6, err_msg=path)


def test_vlm_loss_is_masked_over_the_patches():
    """The patch positions' labels do not move the loss: the mask from
    `embed_batch` is False there, as the reference's."""
    _, tcfg = _cfgs(VLM)
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tb = make_batch(tcfg, InputShape("t", 32, 2, "train"), seed=1,
                    device="cpu")
    x, labels, mask = TM.embed_batch(tcfg, params, tb)
    n = tcfg.num_patches
    assert x.shape == (2, 32, tcfg.d_model) and labels is tb["labels"]
    assert not mask[:, :n].any() and mask[:, n:].all()
    other = dict(tb, labels=tb["labels"].clone())
    other["labels"][:, :n] = (other["labels"][:, :n] + 1) % tcfg.vocab_size
    a, b = (TM.forward(tcfg, params, t)[0] for t in (tb, other))
    assert torch.equal(a, b)
    other["labels"][:, n] = (other["labels"][:, n] + 1) % tcfg.vocab_size
    assert not torch.equal(a, TM.forward(tcfg, params, other)[0])


@pytest.mark.parametrize("hd", [None, 96])
def test_vlm_logits_and_decode_match_reference(hd):
    """phi-3-vision: `logits_fn` on patches and tokens (last logits and
    every cache), then `decode_step` on tokens alone from an empty
    cache, step by step, against the reference's."""
    kw = {} if hd is None else {"head_dim": hd}
    cfg, tcfg = _cfgs(VLM, **kw)
    jparams = jax_init_train_state(cfg, 0).tree()["params"]
    tparams = convert.state_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    jb, tb = _batches(cfg, tcfg, 24, batch=2, kind="prefill")
    jl, jc = JM.logits_fn(cfg, jparams, jb)
    tl, tc = TM.logits_fn(tcfg, tparams, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["pos0"][name].numpy(),
                                   np.asarray(jc["pos0"][name]),
                                   err_msg=name, **TOL)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    jcache = JM.init_cache(cfg, 2, 8)
    tcache = TM.init_cache(tcfg, 2, 8, "cpu")
    for t in range(toks.shape[1]):
        jlg, jcache = JM.decode_step(cfg, jparams, jcache,
                                     jnp.asarray(toks[:, t:t + 1]))
        tlg, tcache = TM.decode_step(tcfg, tparams, tcache,
                                     torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg),
                                   err_msg=f"step {t}", **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_state_stream_matches_reference(arch):
    """The leaves the reference's rules give (phi-3-vision: embed,
    proj_in, its own lm_head; hubert: proj_in and lm_head, no embed), in
    its flatten order, byte for byte."""
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
    top = sorted(own["params"])
    assert top == (["blocks", "embed", "final_norm", "lm_head", "proj_in"]
                   if arch == VLM else
                   ["blocks", "final_norm", "lm_head", "proj_in"])


def test_encoder_has_no_decode_and_hubert_trains_a_step():
    """hubert is an encoder: its decode shapes are skipped as the
    reference skips them; one train step on frames is finite."""
    from repro_torch.configs import INPUT_SHAPES, shape_supported
    cfg = tget(AUDIO)
    for s in ("decode_32k", "long_500k"):
        assert not shape_supported(cfg, INPUT_SHAPES[s])[0]
    assert shape_supported(cfg, INPUT_SHAPES["train_4k"])[0]
    tcfg = tget(AUDIO).reduced()
    state = tsteps.init_train_state(tcfg, 0, device="cpu")
    batch = make_batch(tcfg, InputShape("t", 32, 2, "train"), device="cpu")
    new, metrics = tsteps.make_train_step(tcfg)(state, batch)
    assert torch.isfinite(metrics["loss"]) and int(new["step"]) == 1


@pytest.mark.parametrize("hd", PADDED)
@pytest.mark.parametrize("window,causal", [(None, True), (37, True),
                                           (None, False)])
def test_plain_swa_flash_at_padded_widths_matches_reference(hd, window,
                                                             causal):
    """What the kernels' padded route must compute: the plain version at
    hd 80, 96, 112 against the reference's Pallas kernel (interpret mode,
    as tests/test_kernels.py runs it) and its `flash_attention`."""
    rng = np.random.default_rng(hd)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = f(1, 160, 2, 3, hd), f(1, 160, 2, hd), f(1, 160, 2, hd)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    W = window or FULL_WINDOW
    want = [np.asarray(jax_swa_flash(jq, jk, jv, window=window,
                                     causal=causal, block_q=64,
                                     block_k=32)),
            np.asarray(jax_flash(jq, jk, jv, window=W, causal=causal,
                                 block_q=32, block_k=32))]
    got = KS.swa_flash(*(torch.from_numpy(x) for x in (q, k, v)),
                       window=window, causal=causal)
    for w in want:
        np.testing.assert_allclose(got.numpy(), w, atol=2e-5, rtol=1e-4)
