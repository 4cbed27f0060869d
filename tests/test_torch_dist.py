"""The port's distribution layer (`repro_torch.dist`) against the
reference's (`repro.dist`): `adapt_spec` on the reference's cases and a
hypothesis sweep, the rule tables leaf for leaf for every ported arch at
full width (shapes only), cover-and-divide on the 16x16 mesh, and a
DTensor forward of reduced qwen3-8b and starcoder2-3b on 4 CPU ranks
(gloo, a (2, 2) mesh) held against the unsharded forward."""
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest
from hypothesis import given, strategies as st

import jax
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jax_config
from repro.dist import api as jax_api
from repro.dist import shardings as jax_sh
from repro.models import model as JM
from repro.train.steps import init_train_state as jax_init_state
from repro_torch.configs import get_config, list_configs
from repro_torch.core.treebytes import tree_flatten_with_path
from repro_torch.dist import api, shardings as SH
from repro_torch.dist.api import P
from repro_torch.models import model as M

ROOT = os.path.join(os.path.dirname(__file__), "..")


def fake_mesh(**axes):
    return SimpleNamespace(axis_names=tuple(axes),
                           axis_sizes=tuple(axes.values()))


def ported_archs():
    out = []
    for name in list_configs():
        try:
            M.check_supported(get_config(name))
        except NotImplementedError:
            continue
        out.append(name)
    return out


PORTED = ported_archs()


@pytest.fixture(scope="module", autouse=True)
def _no_process_group_left():
    """The production mesh's fake process group ends with this module."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _entries(spec):
    """A spec's entries with 1-tuples as bare names (JAX's PartitionSpec
    normalises them so; the two mean the same)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


# ------------------------------------------------------------ adapt_spec
def test_adapt_drops_missing_axes():
    mesh = fake_mesh(data=16, model=16)
    assert api.adapt_spec(P("pod", "model"), (32, 32), mesh) == \
        P(None, "model")


def test_adapt_drops_nondividing():
    mesh = fake_mesh(data=16, model=16)
    assert api.adapt_spec(P("model", None), (8, 64), mesh) == P(None, None)
    assert api.adapt_spec(P("model", None), (32, 64), mesh) == \
        P("model", None)


def test_adapt_tuple_prefix():
    mesh = fake_mesh(pod=2, data=16, model=16)
    sp = api.adapt_spec(P(("pod", "data", "model"),), (64,), mesh)
    assert sp == P(("pod", "data"),)


_AXES = ["pod", "data", "model", "expert"]
_entry = st.one_of(st.none(), st.sampled_from(_AXES),
                   st.lists(st.sampled_from(_AXES), min_size=1, max_size=3,
                            unique=True).map(tuple))


@given(sizes=st.dictionaries(st.sampled_from(["pod", "data", "model"]),
                             st.sampled_from([1, 2, 3, 4, 8, 16]),
                             min_size=1),
       spec=st.lists(_entry, max_size=4),
       dims=st.lists(st.sampled_from([1, 2, 6, 8, 12, 16, 48, 64, 96]),
                     min_size=4, max_size=4))
def test_adapt_spec_equals_the_reference(sizes, spec, dims):
    mesh = fake_mesh(**sizes)
    shape = tuple(dims[:len(spec)])
    want = jax_api.adapt_spec(JP(*spec), shape, mesh)
    got = api.adapt_spec(P(*spec), shape, mesh)
    assert _entries(got) == _entries(want)


def test_adapt_spec_reads_a_device_mesh():
    """A DeviceMesh gives its axes by `mesh_dim_names` and its sizes by
    its shape; the same adaptation as the plain mesh object."""
    dm = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 4))
    assert api.adapt_spec(P("data", "model"), (3, 8), dm) == \
        P(None, "model")


def test_placements_follow_mesh_order():
    """A tuple entry shards its tensor dim on each of its mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = fake_mesh(pod=2, data=4, model=8)
    assert api.placements(P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert api.placements(P(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())


def test_shard_is_the_identity_outside_a_mesh_and_on_plain_tensors():
    import torch
    x = torch.ones(4, 4)
    assert api.shard(x, P("data", None)) is x
    with api.use_mesh(fake_mesh(data=2)):
        assert api.shard(x, P("data", None)) is x
    assert api._active_mesh() is None


# ------------------------------------------------------------ rule tables
def _port_shapes(cfg, what):
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.train.steps import init_train_state
    with FakeTensorMode(allow_non_fake_inputs=True):
        if what == "params":
            return M.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
        if what == "state":
            return init_train_state(cfg, 0, device="cpu")
        return M.init_cache(cfg, 8, 64, "cpu")


def _jax_shapes(cfg, what):
    if what == "params":
        return jax.eval_shape(lambda: JM.init_params(
            cfg, jax.random.PRNGKey(0)))
    if what == "state":
        return jax.eval_shape(lambda: jax_init_state(cfg, 0).tree())
    return jax.eval_shape(lambda: JM.init_cache(cfg, 8, 64))


def _flat_jax(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return [(jax.tree_util.keystr(p), _entries(s)) for p, s in flat]


def _flat_port(specs):
    return [(p, _entries(s)) for p, s in tree_flatten_with_path(specs)]


@pytest.mark.parametrize("arch", PORTED)
def test_rule_tables_equal_the_reference(arch):
    """param_specs, state_specs and cache_specs at full width from shapes
    alone, path for path and spec for spec (FSDP and the EP rule on as
    well as off)."""
    mesh = fake_mesh(data=16, model=16)
    for over in ({}, {"fsdp": True}, {"moe_ep": True}):
        pcfg = dataclasses.replace(get_config(arch), **over)
        jcfg = dataclasses.replace(jax_config(arch), **over)
        for what in ("params", "state", "cache"):
            ps, js = _port_shapes(pcfg, what), _jax_shapes(jcfg, what)
            if what == "params":
                got, want = SH.param_specs(pcfg, ps), \
                    jax_sh.param_specs(jcfg, js)
            elif what == "state":
                got, want = SH.state_specs(pcfg, ps), \
                    jax_sh.state_specs(jcfg, js)
            else:
                got, want = SH.cache_specs(pcfg, ps, 8, mesh), \
                    jax_sh.cache_specs(jcfg, js, 8, mesh)
            assert _flat_port(got) == _flat_jax(want), (arch, over, what)


def test_batch_specs_equal_the_reference():
    import numpy as np
    batch = {"tokens": np.zeros((8, 64), np.int32),
             "labels": np.zeros((8, 64), np.int32),
             "scalar": np.zeros((), np.int32)}
    got = SH.batch_specs(None, batch)
    want = jax_sh.batch_specs(None, batch)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


def test_ep_rule_shards_stacked_expert_leaves():
    """The EP rule is in the table (it takes effect once MoE lands): a
    stacked (E, fan-in, fan-out) expert leaf under `moe_ep` gets experts
    over "model" and, under FSDP, fan-in over the batch axes, as the
    reference's."""
    shapes = {"blocks": {"pos0": {"ffn": {
        "wi_gate": SimpleNamespace(shape=(4, 8, 64, 128)),
        "wo": SimpleNamespace(shape=(4, 8, 128, 64)),
        "router": SimpleNamespace(shape=(4, 64, 8))}}}}
    for fsdp in (False, True):
        cfg = SimpleNamespace(moe_ep=True, num_experts=8, fsdp=fsdp)
        got = _flat_port(SH.param_specs(cfg, shapes))
        want = _flat_jax(jax_sh.param_specs(cfg, shapes))
        assert got == want
        assert ("['blocks']['pos0']['ffn']['wi_gate']",
                (None, "model", ("pod", "data") if fsdp else None, None)) \
            in got


@pytest.mark.parametrize("arch", PORTED)
def test_param_specs_cover_and_divide(arch):
    """Every full-size param leaf gets a spec whose axes divide its dims on
    the production (16, 16) mesh, and the big matrices are model-sharded:
    what lets the dry-run build every shard evenly."""
    cfg = get_config(arch)
    shapes = _port_shapes(cfg, "params")
    specs = SH.param_specs(cfg, shapes)
    mesh = fake_mesh(data=16, model=16)
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    n_model_sharded = 0
    for (path, spec), (_, sh) in zip(tree_flatten_with_path(specs),
                                     tree_flatten_with_path(shapes)):
        assert len(spec) <= len(sh.shape), (path, spec, sh.shape)
        adapted = api.adapt_spec(spec, sh.shape, mesh)
        for dim, entry in enumerate(adapted):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            tot = 1
            for nm in names:
                tot *= sizes[nm]
            assert sh.shape[dim] % tot == 0
            if "model" in names:
                n_model_sharded += 1
    assert n_model_sharded >= 4, "big matrices must be model-sharded"


def test_named_gives_placements_on_a_device_mesh():
    """`named` adapts each spec to a DeviceMesh (a fake process group of
    the production mesh's 256 ranks) and gives its DTensor placements."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    cfg = get_config("qwen3-8b")
    shapes = _port_shapes(dataclasses.replace(cfg, num_layers=2), "params")
    ns = SH.named(SH.param_specs(cfg, shapes), shapes, mesh)
    wq = ns["blocks"]["pos0"]["mix"]["wq"]
    assert wq.spec == P(None, None, "model")
    assert wq.placements == (Replicate(), Shard(2))
    assert ns["final_norm"].placements == (Replicate(), Replicate())


# ------------------------------------------------------ DTensor on 4 ranks
WORKER = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, port = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.core.treebytes import leaf_arrays
    from repro_torch.dist import shardings as SH
    from repro_torch.dist.api import use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe
    mesh = make_mesh((2, 2), ("data", "model"))
    # the expert counts each MoE dispatch ran over (EP: 2 a "model" rank)
    seen, dispatch = [], moe._dispatch_compute
    def counted(xf, w, sel, wi_gate, *a, **k):
        seen.append((int(wi_gate.shape[0]), int(xf.shape[0])))
        return dispatch(xf, w, sel, wi_gate, *a, **k)
    moe._dispatch_compute = counted
    for arch, over in (("qwen3-8b", {}),
                       ("starcoder2-3b", {"banded_attention": True}),
                       ("dbrx-132b", {"moe_ep": True}),
                       ("dbrx-132b", {"moe_ep": True, "fsdp": True})):
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(1)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 128)).astype(np.int32))
            for k in ("tokens", "labels")}
        leaves = [t.requires_grad_(True) for t in leaf_arrays(params)]
        # the cross-entropy: the loss less its aux term (0 but for MoE,
        # whose aux under EP is, as the reference's, the mean over the
        # data ranks of each one's own, not the aux of the whole batch)
        want, out = M.forward(cfg, params, batch)
        want = want - 0.01 * out["aux"]
        gw = torch.autograd.grad(want, leaves)
        aux_want = sum(float(M.forward(cfg, params, {
            k: v[h:h + 2] for k, v in batch.items()})[1]["aux"])
            for h in (0, 2)) / 2 if cfg.num_experts else 0.0
        p = SH.distribute(params, SH.named(SH.param_specs(cfg, params),
                                           params, mesh))
        b = SH.distribute(batch, SH.named(SH.batch_specs(cfg, batch),
                                          batch, mesh))
        wq = p["blocks"]["pos0"]["mix"]["wq"]
        assert wq.to_local().shape[-1] * 2 == wq.shape[-1]
        seen.clear()
        with use_mesh(mesh), implicit_replication():
            got, out = M.forward(cfg, p, b)
            got = got - 0.01 * out["aux"]
            gg = torch.autograd.grad(got, leaf_arrays(p))
        got = float(got.full_tensor())
        aux = out["aux"]
        aux = float(aux.full_tensor() if hasattr(aux, "full_tensor")
                    else aux)
        gerr = max(float((g.full_tensor() - w).abs().max()
                         / w.abs().max().clamp(min=1)) for g, w in zip(gg, gw))
        if rank == 0:
            tag = arch + ("+fsdp" if cfg.fsdp else "")
            print(f"LOSS {tag} {float(want)!r} {got!r} {gerr!r}",
                  flush=True)
            print(f"AUX {tag} {aux_want!r} {aux!r}", flush=True)
            print(f"DISPATCH {tag} {sorted(set(seen))}", flush=True)
    # the CE alone, vocabulary split over "model": only all-reduces
    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.dist.api import vocab_nll
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(4, 8, 64, generator=g)
    labels = torch.randint(0, 64, (4, 8), generator=g)
    leaf = logits.clone().requires_grad_(True)
    want = F.cross_entropy(leaf.reshape(-1, 64), labels.reshape(-1),
                           reduction="none").reshape(4, 8)
    (gw,) = torch.autograd.grad(want.sum(), leaf)
    lg = distribute_tensor(logits, mesh, [Shard(0), Shard(2)]) \
        .requires_grad_(True)
    lb = distribute_tensor(labels, mesh, [Shard(0), Replicate()])
    with CommDebugMode() as comm:
        nll = vocab_nll(lg, lb)
        (gl,) = torch.autograd.grad(nll.sum(), lg)
    ops = sorted(str(k) for k in comm.get_comm_counts())
    err = float((nll.full_tensor() - want).abs().max())
    gerr = float((gl.full_tensor() - gw).abs().max())
    if rank == 0:
        print("CE", err, gerr, tuple(nll.to_local().shape),
              tuple(gl.to_local().shape), tuple(gl.placements) ==
              (Shard(0), Shard(2)), "|".join(ops) or "-", flush=True)
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def four_ranks():
    """The worker's output on 4 gloo ranks, a (2, 2) mesh."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
    return outs[0][1].splitlines()


def test_dtensor_forward_on_four_cpu_ranks(four_ranks):
    """Reduced qwen3-8b and starcoder2-3b (the latter banded, so its
    attention runs `swa_flash` through the custom op's sharding rule),
    and reduced dbrx-132b under `moe_ep`, with FSDP off and on (its MoE
    the expert-parallel route: 2 of 4 experts a "model" rank, tokens
    sharded over "data", partial outputs summed over "model"; the
    unsharded forward takes the GSPMD route), with params and batch as
    DTensors on a (2, 2) gloo mesh: the cross-entropy (the loss less
    0.01 times the aux loss) equals the unsharded port forward's within
    1e-5 (fp32), and every gradient of it (the embedding's a partial sum
    over the data ranks) within 1e-5 of its scale. The aux loss (0 but
    for MoE) equals the mean over the data ranks of the unsharded aux
    of each one's rows (the reference's `pmean`) within 1e-6."""
    losses = [line.split() for line in four_ranks
              if line.startswith("LOSS")]
    assert [l[1] for l in losses] == ["qwen3-8b", "starcoder2-3b",
                                      "dbrx-132b", "dbrx-132b+fsdp"]
    for _, arch, want, got, gerr in losses:
        assert abs(float(want) - float(got)) <= 1e-5, (arch, want, got)
        assert float(gerr) <= 1e-5, (arch, gerr)
    auxes = [line.split() for line in four_ranks if line.startswith("AUX")]
    assert [a[1] for a in auxes] == [l[1] for l in losses]
    for _, arch, want, got in auxes:
        assert abs(float(want) - float(got)) <= 1e-6, (arch, want, got)
        assert (float(got) > 0) == arch.startswith("dbrx"), (arch, got)
    # each rank dispatched its own 256 of the 512 tokens to its 2 experts
    routes = {l.split()[1]: l.split(" ", 2)[2] for l in four_ranks
              if l.startswith("DISPATCH")}
    assert routes["dbrx-132b"] == routes["dbrx-132b+fsdp"] == "[(2, 256)]"
    assert routes["qwen3-8b"] == "[]", routes


def test_vocab_parallel_ce_on_four_cpu_ranks(four_ranks):
    """`dist.api.vocab_nll` on (4, 8, 64) logits laid out [Shard(0),
    Shard(2)] on the (2, 2) mesh: the NLL equals `F.cross_entropy`'s and
    the gradient autograd's within 1e-6, each rank holds 2 rows of 32
    columns of the gradient, and the forward and backward issue
    all-reduces only (no gather of the logits)."""
    (line,) = [l.split() for l in four_ranks if l.startswith("CE")]
    _, err, gerr, nll_shape, grad_shape, placed, ops = (
        line[0], line[1], line[2], " ".join(line[3:5]),
        " ".join(line[5:8]), line[8], line[9])
    assert float(err) <= 1e-6 and float(gerr) <= 1e-6, (err, gerr)
    assert nll_shape == "(2, 8)" and grad_shape == "(2, 8, 32)"
    assert placed == "True"
    assert ops != "-" and all("all_reduce" in op for op in ops.split("|")), \
        ops
