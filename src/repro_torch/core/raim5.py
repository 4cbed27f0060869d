"""RAIM5 — Redundant Array of Independent Memory 5 (paper §4.3).

The SG's full state (W bytes) is cut into n stripes x (n-1) equal blocks.
Layout (matches Figure 7): stripe s keeps its parity on node s; data block
j of stripe s lives on node (s + 1 + j) mod n.  Each node therefore:

  * persists (n-1) data blocks  (its 1/n shard of W), and
  * additionally snapshots the (n-1) blocks of its parity stripe —
    "doubling the snapshotting parameter size" — XORs them locally into
    one parity block, then releases them.

Any single node loss per SG is decodable: the dead node's parity is
re-encoded from survivors, and each of its data blocks is XOR-decoded from
its stripe's parity + surviving siblings.

XOR runs on uint64 lanes on the host (paper: "byte-wise on the CPU"); the
CUDA encode kernel (kernels/stage.py) is the beyond-paper on-device
variant of the save-side fold.  Decode is encode-agnostic: XOR is
its own inverse and the device encode path produces byte-identical parity
blocks, so `decode_node` reconstructs kernel-encoded and host-encoded
snapshots alike — no format flag, no second path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


def block_size(total_bytes: int, n: int) -> int:
    """Equal block size (padded up) for n nodes: n*(n-1) blocks cover W."""
    nblocks = n * (n - 1)
    return -(-total_bytes // nblocks)           # ceil


@dataclass(frozen=True)
class BlockRef:
    stripe: int
    index: int                                   # data block index in stripe

    def byte_range(self, bs: int, n: int) -> Tuple[int, int]:
        blk = self.stripe * (n - 1) + self.index
        return blk * bs, (blk + 1) * bs


def node_of_block(stripe: int, index: int, n: int) -> int:
    return (stripe + 1 + index) % n


def data_blocks_of_node(node: int, n: int) -> List[BlockRef]:
    """The (n-1) data blocks stored on `node` (one per stripe != node)."""
    out = []
    for s in range(n):
        if s == node:
            continue
        j = (node - s - 1) % n
        assert node_of_block(s, j, n) == node and 0 <= j < n - 1
        out.append(BlockRef(s, j))
    return out


def local_block_index(node: int, stripe: int, index: int, n: int) -> int:
    """Slot of data block (stripe, index) within `node`'s local shard
    (the `data_blocks_of_node` order every store layout follows)."""
    refs = data_blocks_of_node(node, n)
    return next(i for i, r in enumerate(refs)
                if (r.stripe, r.index) == (stripe, index))


def parity_stripe_of_node(node: int, n: int) -> List[BlockRef]:
    """Blocks XOR-ed into the parity that `node` stores (its own stripe)."""
    return [BlockRef(node, j) for j in range(n - 1)]


def snapshot_ranges(node: int, n: int, total_bytes: int
                    ) -> List[Tuple[int, int]]:
    """Byte ranges this node must snapshot: own data blocks + parity-stripe
    blocks (the doubled traffic of §4.3), clipped to total_bytes."""
    bs = block_size(total_bytes, n)
    refs = data_blocks_of_node(node, n) + parity_stripe_of_node(node, n)
    out = []
    for r in refs:
        lo, hi = r.byte_range(bs, n)
        out.append((min(lo, total_bytes), min(hi, total_bytes)))
    return out


def xor_blocks(blocks: Sequence[np.ndarray]) -> np.ndarray:
    """XOR-reduce equal-length byte blocks on uint64 lanes."""
    assert blocks, "no blocks"
    n = blocks[0].nbytes
    pad = (-n) % 8
    acc = None
    for b in blocks:
        assert b.nbytes == n
        v = b.reshape(-1).view(np.uint8)
        if pad:
            v = np.concatenate([v, np.zeros(pad, np.uint8)])
        v64 = v.view(np.uint64)
        acc = v64.copy() if acc is None else np.bitwise_xor(acc, v64, out=acc)
    return acc.view(np.uint8)[:n]


def encode_parity(node: int, n: int, full_state: np.ndarray) -> np.ndarray:
    """Parity block for `node`'s stripe, from the (replicated) full state.
    Blocks beyond total_bytes are zero-padded (XOR identity)."""
    bs = block_size(full_state.nbytes, n)
    blocks = []
    for ref in parity_stripe_of_node(node, n):
        lo, hi = ref.byte_range(bs, n)
        blk = np.zeros(bs, np.uint8)
        a, b = min(lo, full_state.nbytes), min(hi, full_state.nbytes)
        if b > a:
            blk[:b - a] = full_state[a:b]
        blocks.append(blk)
    return xor_blocks(blocks)


def decode_node(failed: int, n: int, total_bytes: int,
                read_block, read_parity) -> Dict[Tuple[int, int], np.ndarray]:
    """Reconstruct every data block of `failed`.

    read_block(node, stripe, index) -> np.uint8[bs]   (from survivor SMPs)
    read_parity(node) -> np.uint8[bs]
    Returns {(stripe, index): bytes} for the failed node's blocks.
    """
    bs = block_size(total_bytes, n)
    out = {}
    for ref in data_blocks_of_node(failed, n):
        s = ref.stripe
        assert s != failed
        siblings = [read_block(node_of_block(s, j, n), s, j)
                    for j in range(n - 1) if j != ref.index]
        parity = read_parity(s)                  # stripe s parity on node s
        out[(s, ref.index)] = xor_blocks(siblings + [parity])
    return out


# ----------------------------------------------------- range-limited decode
def blocks_intersecting(failed: int, n: int, total_bytes: int,
                        ranges: Sequence[Tuple[int, int]]
                        ) -> List[Tuple[BlockRef, List[Tuple[int, int]]]]:
    """`failed`'s data blocks whose global byte span intersects `ranges`,
    each with the block-LOCAL sub-ranges [(o1, o2), ...] that do.

    `ranges` must be sorted, disjoint global [lo, hi) pairs.  This is the
    planning half of range-limited decode: a restore that only needs a
    few byte ranges of a lost member pays XOR + sibling reads for exactly
    the intersecting stripe sub-ranges, not the whole shard."""
    bs = block_size(total_bytes, n)
    out: List[Tuple[BlockRef, List[Tuple[int, int]]]] = []
    for ref in data_blocks_of_node(failed, n):
        g_lo, g_hi = ref.byte_range(bs, n)
        g_hi = min(g_hi, total_bytes)
        subs = []
        for a, b in ranges:
            a2, b2 = max(a, g_lo), min(b, g_hi)
            if b2 > a2:
                subs.append((a2 - g_lo, b2 - g_lo))
        if subs:
            out.append((ref, subs))
    return out


def decode_node_ranges(failed: int, n: int, total_bytes: int,
                       ranges: Sequence[Tuple[int, int]],
                       read_block_range, read_parity_range
                       ) -> Dict[Tuple[int, int],
                                 List[Tuple[int, int, np.ndarray]]]:
    """Reconstruct only the sub-ranges of `failed`'s blocks that intersect
    the global byte `ranges` (sorted, disjoint).

    XOR decode is byte-wise, so a lost block's bytes [o1, o2) are exactly
    the XOR of the SAME offsets of its stripe's surviving siblings and
    parity — no whole-block (let alone whole-shard) decode is needed:

      read_block_range(node, stripe, index, o1, o2) -> np.uint8[o2-o1]
      read_parity_range(stripe, o1, o2)             -> np.uint8[o2-o1]

    Returns {(stripe, index): [(o1, o2, bytes), ...]} covering only the
    requested intersections.
    """
    out: Dict[Tuple[int, int], List[Tuple[int, int, np.ndarray]]] = {}
    for ref, subs in blocks_intersecting(failed, n, total_bytes, ranges):
        s = ref.stripe
        assert s != failed
        pieces = []
        for o1, o2 in subs:
            parts = [read_block_range(node_of_block(s, j, n), s, j, o1, o2)
                     for j in range(n - 1) if j != ref.index]
            parts.append(read_parity_range(s, o1, o2))
            pieces.append((o1, o2, xor_blocks(parts)))
        out[(s, ref.index)] = pieces
    return out


def reassemble(n: int, total_bytes: int, read_block,
               recovered: Dict[Tuple[int, int], np.ndarray] = None
               ) -> np.ndarray:
    """Full state bytes from all data blocks (survivors + recovered)."""
    bs = block_size(total_bytes, n)
    recovered = recovered or {}
    full = np.zeros(n * (n - 1) * bs, np.uint8)
    for s in range(n):
        for j in range(n - 1):
            lo, hi = BlockRef(s, j).byte_range(bs, n)
            blk = recovered.get((s, j))
            if blk is None:
                blk = read_block(node_of_block(s, j, n), s, j)
            full[lo:hi] = blk
    return full[:total_bytes]
