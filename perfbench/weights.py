"""Initial weights from the seed, made by the benchmark and handed alike
to the program and to the reference.

The layout is the program's parameter tree (the period-stacked layout:
every layer's leaves stacked on a leading axis under `blocks/pos0`), and
the recipe the program's own initialisation follows: each matrix a
normal draw times fan_in ** -0.5 (the embedding 0.02), the norms' gains
zero (applied as 1 + g), the SSM's A_log 0, dt_bias 0.5, D 1. Every
random leaf comes from one `torch.randn` call on the card in bfloat16,
the type the model is trained in; the leaves are views into it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

Path = Tuple[str, ...]


@dataclass(frozen=True)
class Leaf:
    path: Path
    shape: Tuple[int, ...]
    dtype: str                 # "bfloat16" or "float32"
    init: Tuple                # ("normal", scale) | ("const", value)


def ssm_dims(c: dict):
    """(d_inner, heads, conv channels) of a Mamba2 layer."""
    di = c["ssm_expand"] * c["d_model"]
    return di, di // c["ssm_head_dim"], di + 2 * c["ssm_state"]


def layout(c: dict) -> List[Leaf]:
    """The leaves of configuration `c` (a `configs/<name>.json`)."""
    L, D, V = c["num_layers"], c["d_model"], c["vocab_size"]
    pd = c["param_dtype"]
    out = [Leaf(("embed",), (V, D), pd, ("normal", 0.02))]

    def blk(name, shape, init, dtype=pd):
        out.append(Leaf(("blocks", "pos0") + name, (L, *shape), dtype, init))

    zero = ("const", 0.0)
    blk(("ln1",), (D,), zero)
    if c["family"] == "ssm":
        di, H, ch = ssm_dims(c)
        N, W = c["ssm_state"], c["ssm_conv_width"]
        blk(("mix", "in_proj"), (D, 2 * di + 2 * N + H), ("normal", D ** -0.5))
        blk(("mix", "conv_w"), (W, ch), ("normal", W ** -0.5))
        blk(("mix", "conv_b"), (ch,), zero)
        blk(("mix", "A_log"), (H,), zero, "float32")
        blk(("mix", "dt_bias"), (H,), ("const", 0.5), "float32")
        blk(("mix", "D_skip"), (H,), ("const", 1.0), "float32")
        blk(("mix", "gate_norm"), (di,), zero)
        blk(("mix", "out_proj"), (di, D), ("normal", di ** -0.5))
    else:
        raise ValueError(f"{c['name']}: the benchmark builds the ssm "
                         f"family, not {c['family']!r}")
    out.append(Leaf(("final_norm",), (D,), pd, zero))
    if not c.get("tie_embeddings", False):
        out.append(Leaf(("lm_head",), (D, V), pd, ("normal", D ** -0.5)))
    return out


def numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make(c: dict, seed: int, device) -> Dict[Path, "object"]:
    """{path: tensor} of configuration `c` for `seed`, on `device`."""
    import torch
    leaves = layout(c)
    normal = [x for x in leaves if x.init[0] == "normal"]
    if {x.dtype for x in normal} != {"bfloat16"}:
        raise ValueError("the random leaves are drawn in bfloat16")
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64)
    buf = torch.randn(sum(numel(x.shape) for x in normal), generator=gen,
                      dtype=torch.bfloat16, device=device)
    out, off = {}, 0
    for x in leaves:
        if x.init[0] == "normal":
            n = numel(x.shape)
            out[x.path] = buf[off:off + n].view(x.shape).mul_(x.init[1])
            off += n
        else:
            out[x.path] = torch.full(x.shape, x.init[1],
                                     dtype=getattr(torch, x.dtype),
                                     device=device)
    return out


def nest(flat: Dict[Path, "object"]) -> dict:
    """{path: leaf} -> the nested dict tree the program takes."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def flatten(tree, prefix: Path = ()) -> Dict[Path, "object"]:
    """The inverse of `nest`, for any nested dict (keys sorted)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], prefix + (k,)))
    return out
