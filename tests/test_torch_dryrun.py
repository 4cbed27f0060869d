"""The port's dry-run (`repro_torch.launch.dryrun`) against the
reference's (`repro.launch.dryrun`) on reduced gemma3-4b and mamba2-130m
(train, prefill, decode) on the same (2, 4) mesh: the same tokens a step,
model FLOPs and parameter counts, the same argument bytes per chip (set by
the shardings alone), and global FLOPs within a stated factor of XLA's
(the partitioners differ). Also: per-chip counting pinned on a (1, 4)
model-only mesh, the custom ops' FLOP formulas against the bounds'
counts, and the CLI's `[not ported]` and `[skip]` records."""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import make_mesh

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("gemma3-4b", "mamba2-130m")
SHAPES = {"t_train": InputShape("t_train", 64, 8, "train"),
          "t_prefill": InputShape("t_prefill", 64, 8, "prefill"),
          "t_decode": InputShape("t_decode", 64, 8, "decode")}
PAIRS = [(a, s) for a in ARCHS for s in SHAPES]
KEYS = ("tokens_per_step", "model_flops", "params_total", "params_active")
# global FLOPs of the port (DTensor's partition, eager ops, every custom
# op by its kernel's formula) over XLA's (GSPMD, fused HLO): measured
# 0.97-1.8 on these pairs; held within this factor either way
FLOPS_FACTOR = 2.5

REFERENCE = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, jax
    from repro.configs import get_config
    from repro.configs.base import INPUT_SHAPES, InputShape
    from repro.launch import dryrun as DR
    shapes = json.loads(os.environ["SHAPES"])
    for name, (seq, batch, kind) in shapes.items():
        INPUT_SHAPES[name] = InputShape(name, seq, batch, kind)
    at = getattr(jax.sharding, "AxisType", None)
    kw = {"axis_types": (at.Auto,) * 2} if at is not None else {}
    mesh = jax.make_mesh((2, 4), ("data", "model"), **kw)
    out = {}
    for arch in json.loads(os.environ["ARCHS"]):
        cfg = dataclasses.replace(get_config(arch).reduced(), name=arch)
        for s in shapes:
            low, meta = DR.build_lowered(arch, s, mesh, cfg=cfg, unroll=True)
            out[arch + "/" + s] = DR.analyse(low, low.compile(), meta, cfg)
    print("JSON" + json.dumps(out))
""")


@pytest.fixture(scope="module", autouse=True)
def _shapes():
    INPUT_SHAPES.update(SHAPES)
    yield
    for s in SHAPES:
        INPUT_SHAPES.pop(s, None)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def records(_shapes):
    """(port, reference) records of every pair; the reference runs in a
    subprocess with 8 forced CPU devices while the port traces."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               ARCHS=json.dumps(ARCHS),
               SHAPES=json.dumps({k: (v.seq_len, v.global_batch, v.kind)
                                  for k, v in SHAPES.items()}))
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        mesh = make_mesh((2, 4), ("data", "model"))
        port = {}
        for arch, s in PAIRS:
            cfg = dataclasses.replace(get_config(arch).reduced(), name=arch)
            port[f"{arch}/{s}"] = DR.run_pair(arch, s, multi_pod=False,
                                              cfg=cfg, mesh=mesh,
                                              verbose=False)
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    line = [l for l in out.splitlines() if l.startswith("JSON")]
    assert line, err[-3000:]
    return port, json.loads(line[0][4:])


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_record_equals_the_reference(records, arch, shape):
    port, ref = (r[f"{arch}/{shape}"] for r in records)
    assert {k: port[k] for k in KEYS} == {k: ref[k] for k in KEYS}
    assert port["memory"]["argument_bytes"] == \
        ref["memory"]["argument_bytes"]
    assert port["chips"] == ref["chips"] == 8
    assert port["mesh"] == ref["mesh"] == "2x4"
    ratio = port["hlo_flops_global"] / ref["hlo_flops_global"]
    assert 1 / FLOPS_FACTOR <= ratio <= FLOPS_FACTOR, ratio
    assert port["hlo_flops_per_chip"] * 8 == port["hlo_flops_global"]
    for key in ("t_compute_s", "t_memory_s", "t_collective_s"):
        assert port[key] >= 0
    assert port["memory"]["peak_bytes"] >= \
        port["memory"]["argument_bytes"] > 0


def test_per_chip_flops_divide_over_the_model_axis():
    """Reduced qwen3-8b with 4 KV heads (every head shards) on a (1, 4)
    mesh: a prefill's per-chip FLOPs are exactly 1/4 of the (1, 1)
    mesh's, so the counters see one chip's shards, not the global op;
    in the train step's backward some products take DTensor strategies
    that repeat them on every model rank, so its share stays above 1/4
    (0.353 measured)."""
    cfg = dataclasses.replace(get_config("qwen3-8b").reduced(),
                              name="qwen3-8b", num_kv_heads=4)
    flops = {}
    for shape in ((1, 1), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"))
        for s in ("t_prefill", "t_train"):
            flops[shape, s] = DR.run_pair("qwen3-8b", s, multi_pod=False,
                                          cfg=cfg, mesh=mesh,
                                          verbose=False)["hlo_flops_per_chip"]
    assert flops[(1, 4), "t_prefill"] * 4 == flops[(1, 1), "t_prefill"]
    share = flops[(1, 4), "t_train"] / flops[(1, 1), "t_train"]
    assert 0.25 < share < 0.4, share


def test_flop_counter_mode_sees_the_global_op():
    """Pinned: torch's FlopCounterMode, a dispatch mode above DTensor,
    counts a DTensor matmul at its global shape; the dry-run's counters
    count rank 0's local matmul."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    mesh = make_mesh((1, 4), ("data", "model"))
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(8, 64), mesh,
                               [Replicate(), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(64, 32), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        with FlopCounterMode(display=False) as fc:
            x @ w
        acct = DR._Accounting()
        with DR._quiet_shape_inference(acct), acct:
            x @ w
    assert fc.get_total_flops() == 2 * 8 * 64 * 128
    assert acct.flops == 2 * 8 * 64 * 32


def test_shape_inference_is_paused_not_counted():
    """The counters pause inside DTensor's global shape inference through
    a private torch method: on shapes no earlier op cached, that method
    is entered, and the matmul counts its local FLOPs alone (a torch that
    renamed it fails here, not by counting the global op too)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    assert callable(getattr(ShardingPropagator,
                            "_propagate_tensor_meta_non_cached", None))
    mesh = make_mesh((1, 4), ("data", "model"))
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(24, 72), mesh,
                               [Replicate(), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(72, 10), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        acct = DR._Accounting()
        with DR._quiet_shape_inference(acct), acct:
            x @ w
    assert acct.shape_inferences >= 1 and acct.paused == 0
    assert acct.flops == 2 * 24 * 72 * 10


def _brute_pairs(S, window, causal):
    import numpy as np
    i = np.arange(S)
    d = i[:, None] - i[None, :]
    w = S if window is None else window
    ok = (np.abs(d) < w) & ((d >= 0) if causal else True)
    return int(ok.sum())


@pytest.mark.parametrize("S,window,causal", [
    (2048, 512, True), (1000, None, True), (200, 70, True), (96, 20, False),
    (64, 1, True), (300, None, False)])
def test_swa_flop_formula_counts_the_band_pairs(S, window, causal):
    """The custom ops' formulas count the mask's (query, key) pairs: 4 hd
    a pair and head forward (S, PV), 10 backward (S, dP, dV, dQ, dK)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    sw = importlib.import_module("repro_torch.kernels.swa_attention")
    B, KV, G, hd = 2, 2, 3, 64
    pairs = _brute_pairs(S, window, causal)
    assert sw.band_pairs(S, S, window, causal) == pairs
    heads = B * KV * G
    q = torch.empty(B, S, KV, G, hd, device="meta")
    k = torch.empty(B, S, KV, hd, device="meta")
    w = sw._window(window)
    with FlopCounterMode(display=False) as fc:
        o, lse = sw.swa_flash_fwd_op(q, k, k, w, causal)
    assert fc.get_total_flops() == 4 * hd * pairs * heads
    with FlopCounterMode(display=False) as fc:
        sw.swa_flash_bwd_op(o, q, k, k, o, lse, w, causal)
    assert fc.get_total_flops() == 10 * hd * pairs * heads


def test_flop_formulas_are_the_bounds_counts():
    """At the main paths' shapes the formulas give the operations
    `PERF.md` §6's bounds count (`chip_smoke.py` computes the bounds from
    these same functions): swa_flash at starcoder2-3b's call 721.6 /
    1803.9 GFLOP, the SSD at mamba2-130m's 4.97 / 11.69 GFLOP."""
    sw = importlib.import_module("repro_torch.kernels.swa_attention")
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    assert sw.swa_flops((1, 16384, 2, 12, 128), (1, 16384, 2, 128), 4096,
                        True) == (721_579_671_552, 1_803_949_178_880)
    assert ss.ssd_flops(2, 2048, 24, 64, 128, 256) == \
        (4_972_871_680, 11_691_098_112)
    # the padded widths count their real hd: hubert-xlarge's call (hd 80,
    # non-causal) 171.8 / 429.5 GFLOP, phi-3-vision's prefill row (hd 96)
    assert sw.swa_flops((2, 4096, 16, 1, 80), (2, 4096, 16, 80), None,
                        False) == (171_798_691_840, 429_496_729_600)
    assert sw.swa_flops((1, 32768, 32, 1, 96), (1, 32768, 32, 96), None,
                        True)[0] == 4 * 96 * 32 * (32768 * 32769 // 2)


@pytest.mark.parametrize("hd", [80, 96, 112])
def test_custom_ops_count_and_shape_the_real_head_width(hd):
    """At a padded width (the kernels run hd 128 on zero-filled columns)
    the fake impls keep the real hd and the formulas count it."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    sw = importlib.import_module("repro_torch.kernels.swa_attention")
    B, S, KV, G = 1, 300, 2, 8
    q = torch.empty(B, S, KV, G, hd, device="meta")
    k = torch.empty(B, S, KV, hd, device="meta")
    pairs = _brute_pairs(S, 70, True)
    with FlopCounterMode(display=False) as fc:
        o, lse = sw.swa_flash_fwd_op(q, k, k, 70, True)
    assert o.shape == q.shape and lse.shape == (B, KV, G, S)
    assert fc.get_total_flops() == 4 * hd * pairs * B * KV * G
    with FlopCounterMode(display=False) as fc:
        dq, dk, dv = sw.swa_flash_bwd_op(o, q, k, k, o, lse, 70, True)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert fc.get_total_flops() == 10 * hd * pairs * B * KV * G


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (32, 32768, 24, 64, 128, 256), (1, 2048, 24, 64, 128, 256),
    (1, 2000, 4, 64, 128, 256), (1, 257, 2, 64, 128, 256)])
def test_ssd_flop_formula_reaches_the_counter(B, S, H, P, N, chunk):
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    fwd, bwd = ss.ssd_flops(B, S, H, P, N, ss.chunk_len(S, chunk))
    u = torch.empty(B, S, H, P, device="meta")
    a = torch.empty(B, S, H, device="meta")
    bm = torch.empty(B, S, N, device="meta")
    with FlopCounterMode(display=False) as fc:
        y, hf, hs = ss.ssd_scan_fwd_op(u, a, bm, bm, None, chunk)
    assert fc.get_total_flops() == fwd
    with FlopCounterMode(display=False) as fc:
        ss.ssd_scan_bwd_op(y, None, u, a, bm, bm, hs, chunk)
    assert fc.get_total_flops() == bwd


def test_cli_records_not_ported_and_skipped_pairs(tmp_path, capsys,
                                                 monkeypatch):
    """A family the port lacks (a config of an unknown family, since
    every registered one is ported) is `[not ported]` with
    check_supported's message (not folded into `[skip]`); a ported pair
    the reference skips too is `[skip]` (hubert, an encoder, has no
    decode step); neither is a failure."""
    odd = dataclasses.replace(get_config("opt-125m"), name="retnet-1b",
                              family="retention")
    monkeypatch.setattr(DR, "get_config", lambda a: odd if a == odd.name
                        else get_config(a))
    out = tmp_path / "rec.jsonl"
    for arch, shape in (("retnet-1b", "train_4k"),
                        ("hubert-xlarge", "decode_32k"),
                        ("qwen3-8b", "long_500k")):
        assert DR.main(["--arch", arch, "--shape", shape,
                        "--json", str(out)]) == 0
    text = capsys.readouterr().out
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    assert "[not ported] retnet-1b x train_4k: retnet-1b: ported are" in text
    assert "family 'retention' is unknown" in recs[0]["not_ported"]
    assert recs[1] == {"arch": "hubert-xlarge", "shape": "decode_32k",
                       "skipped": "encoder-only architecture has no "
                                  "decode step"}
    assert "[skip] qwen3-8b x long_500k" in text
    assert recs[2] == {"arch": "qwen3-8b", "shape": "long_500k",
                       "skipped": "full-attention arch without "
                                  "sub-quadratic variant"}


def test_all_pairs_triage_as_the_cli_counts_them():
    """`--all`'s 40 pairs, sorted as `main` sorts them (`triage`, no
    tracing): 33 records (jamba's four among them), 7 `[skip]` (hubert's
    two decode shapes, and long_500k of the five full-attention archs:
    qwen3, deepseek, phi-3-vision and the MoE archs dbrx and kimi-k2), 0
    `[not ported]`; a config of an unknown family would be."""
    from repro_torch.configs import ASSIGNED_ARCHS
    kinds = {"record": [], "skip": [], "not ported": []}
    for a in ASSIGNED_ARCHS:
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            try:
                DR.triage(get_config(a), INPUT_SHAPES[s])
                kinds["record"].append((a, s))
            except DR.SkipPair:
                kinds["skip"].append((a, s))
            except DR.NotPorted:
                kinds["not ported"].append((a, s))
    assert {k: len(v) for k, v in kinds.items()} == \
        {"record": 33, "skip": 7, "not ported": 0}
    for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert ("jamba-v0.1-52b", s) in kinds["record"]
    with pytest.raises(DR.NotPorted, match="'retention' is unknown"):
        DR.triage(dataclasses.replace(get_config("opt-125m"),
                                      family="retention"),
                  INPUT_SHAPES["train_4k"])
    assert sorted(kinds["skip"]) == sorted(
        [("hubert-xlarge", "decode_32k"), ("hubert-xlarge", "long_500k"),
         ("qwen3-8b", "long_500k"), ("deepseek-67b", "long_500k"),
         ("phi-3-vision-4.2b", "long_500k"), ("dbrx-132b", "long_500k"),
         ("kimi-k2-1t-a32b", "long_500k")])
    for a in ("hubert-xlarge", "phi-3-vision-4.2b", "dbrx-132b",
              "kimi-k2-1t-a32b"):
        assert (a, "train_4k") in kinds["record"]
        assert (a, "prefill_32k") in kinds["record"]


def test_a_view_adds_nothing_to_the_peak():
    """The peak counts an op's fresh outputs beside what is live; a view
    (an output on a storage already live) allocates nothing. A step
    whose last op views its whole cache stack once counted the stack
    twice."""
    import torch
    acct = DR._Accounting()
    with acct:
        x = torch.ones(256, 256)
        whole = x.view(-1)
        half = x[:128]
        assert acct.peak == x.numel() * 4
        y = x + 1
    assert acct.peak == 2 * x.numel() * 4
    del whole, half, y
