"""LocalCluster — a real-process simulation of one sharding group.

Spawns one OS process per "node"; each node runs a deterministic trainer
loop with a real SnapshotEngine (whose SMP is a further child process).
Fault injection is real: software failure = SIGKILL the trainer (orphaning
its SMP, which survives and keeps the shared-memory snapshot); node failure
= SIGKILL trainer + SMP and unlink the node's segments.

The trainer state evolves by an exact integer-friendly update so recovery
can be asserted *bit-exact* against the independently recomputed state.
The trainer is numpy (the same bytes as the JAX package's trainer); the
engine takes its leaves as they are, and the nodes stay on the CPU — a
node process never touches CUDA.
"""
from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass
from multiprocessing import get_context
from typing import Dict, Optional

import numpy as np

from repro_torch.core.smp import ReadOnlyNode
from repro_torch.core.snapshot import ReftConfig, SnapshotEngine
from repro_torch.core.treebytes import (dtype_name, host_bytes,
                                        make_flat_spec, tree_map)

_MP = get_context("spawn")


def make_state(seed: int, nbytes_approx: int = 1 << 16) -> dict:
    """Deterministic initial trainer state (numpy pytree)."""
    rng = np.random.default_rng(seed)
    n = max(64, nbytes_approx // 16)
    return {
        "params": {"w": rng.standard_normal(n).astype(np.float32),
                   "b": rng.standard_normal(n // 4).astype(np.float32)},
        "opt": {"mu": np.zeros(n, np.float32),
                "nu": np.zeros(n // 4, np.float64)},
        "step": np.int64(0),
        "rng_state": rng.integers(0, 2 ** 31, size=4).astype(np.int64),
    }


def as_numpy(tree):
    """The same tree with numpy leaves (a restore returns host tensors)."""
    def leaf(x):
        if isinstance(x, np.ndarray) or np.isscalar(x):
            return x
        return host_bytes(x).view(dtype_name(x)).reshape(tuple(x.shape))
    return tree_map(leaf, tree)


def update_state(state: dict, step: int) -> dict:
    """Exact, reproducible pseudo-training update (numpy or host-tensor
    leaves in, numpy leaves out)."""
    state = as_numpy(state)
    return {
        "params": {"w": state["params"]["w"] + np.float32(step),
                   "b": state["params"]["b"] * np.float32(-1.0)},
        "opt": {"mu": state["opt"]["mu"] + np.float32(1.0),
                "nu": state["opt"]["nu"] + np.float64(step) * 0.5},
        "step": np.int64(step),
        "rng_state": state["rng_state"] ^ np.int64(step),
    }


def state_at(seed: int, step: int, nbytes_approx: int = 1 << 16) -> dict:
    s = make_state(seed, nbytes_approx)
    for t in range(1, step + 1):
        s = update_state(s, t)
    return s


def _node_main(conn, node: int, n: int, run: str, seed: int,
               nbytes: int, max_steps: int, snapshot_every: int,
               step_time: float, ckpt_dir: str, bucket_bytes: int,
               start_state_blob):
    import pickle
    state = (pickle.loads(start_state_blob) if start_state_blob
             else make_state(seed, nbytes))
    start = int(state["step"])
    cfg = ReftConfig(bucket_bytes=bucket_bytes, ckpt_dir=ckpt_dir,
                     checkpoint_every_snapshots=10 ** 9)
    engine = SnapshotEngine(node, n, state, cfg, run_id=run)
    # analyze: ok ANZ003 — lockstep sim: one thread per pipe end
    conn.send(("smp_pid", engine.smp.proc.pid))
    step = start
    try:
        while True:
            # Lockstep: the coordinator's "go" plays the role of the
            # synchronous all-reduce barrier of DP training.
            cmd = conn.recv()
            if cmd == "ckpt":
                path = os.path.join(
                    ckpt_dir,
                    f"step-{engine.last_clean_step}-node-{node}.reft")
                engine.persist(path)
                conn.send(("ckpted",  # analyze: ok ANZ003 — lockstep
                           engine.last_clean_step))
                continue
            if cmd == "stats":
                conn.send(("stats", engine.stats))  # analyze: ok ANZ003 — lockstep
                continue
            if cmd == "stop":
                break
            assert cmd == "go", cmd
            step += 1
            state = update_state(state, step)
            if step_time:
                # analyze: ok ANZ007 — simulated fwd+bwd compute time
                time.sleep(step_time)
            if step % snapshot_every == 0:
                engine.snapshot_sync(state, step,
                                     extra_meta={"seed": seed})
            conn.send(("at", step))  # analyze: ok ANZ003 — lockstep
    finally:
        engine.close()


@dataclass
class NodeProc:
    proc: object
    conn: object
    smp_pid: Optional[int] = None
    last_step: int = 0
    last_ckpt: int = -1
    alive: bool = True


class LocalCluster:
    """One SG of `n` node processes on this host."""

    def __init__(self, n: int, *, seed: int = 0, nbytes: int = 1 << 16,
                 max_steps: int = 10 ** 6, snapshot_every: int = 1,
                 step_time: float = 0.0, ckpt_dir: str = "/tmp/reft-ckpt",
                 bucket_bytes: int = 1 << 20, run_id: str = None,
                 spec=None):
        import uuid
        if spec is not None:            # repro_torch.api.CheckpointSpec
            if spec.backend != "reft":
                raise ValueError(
                    f"LocalCluster simulates the REFT stack (SMP processes "
                    f"+ RAIM5); got spec.backend={spec.backend!r}")
            ckpt_dir = spec.ckpt_dir
            bucket_bytes = spec.bucket_bytes
            snapshot_every = spec.snapshot_every_steps
            run_id = run_id or spec.run_id
        self.n, self.seed, self.nbytes = n, seed, nbytes
        self.run = run_id or uuid.uuid4().hex[:8]
        self.ckpt_dir = ckpt_dir
        os.makedirs(ckpt_dir, exist_ok=True)
        self.template = make_state(seed, nbytes)
        self.total_bytes = make_flat_spec(self.template).total_bytes
        self.last_load_stats = None           # LoadStats of the last recover
        self.nodes: Dict[int, NodeProc] = {}
        self._args = dict(n=n, run=self.run, seed=seed, nbytes=nbytes,
                          max_steps=max_steps, snapshot_every=snapshot_every,
                          step_time=step_time, ckpt_dir=ckpt_dir,
                          bucket_bytes=bucket_bytes)
        for i in range(n):
            self._spawn(i)

    def _spawn(self, node: int, start_state_blob=None):
        import pickle
        parent, child = _MP.Pipe()
        a = self._args
        p = _MP.Process(target=_node_main,
                        args=(child, node, a["n"], a["run"], a["seed"],
                              a["nbytes"], a["max_steps"],
                              a["snapshot_every"], a["step_time"],
                              a["ckpt_dir"], a["bucket_bytes"],
                              start_state_blob),
                        name=f"trainer-{self.run}-n{node}")
        p.start()
        child.close()
        np_ = NodeProc(proc=p, conn=parent)
        self.nodes[node] = np_

    # ---------------------------------------------------------- control
    def pump(self, node: int, timeout: float = 0.0):
        """Drain progress messages from a node."""
        np_ = self.nodes[node]
        while np_.conn.poll(timeout):
            msg = np_.conn.recv()
            if msg[0] == "smp_pid":
                np_.smp_pid = msg[1]
            elif msg[0] == "at":
                np_.last_step = msg[1]
            elif msg[0] == "done":
                np_.last_step = msg[1]
            elif msg[0] == "ckpted":
                np_.last_ckpt = msg[1]
            timeout = 0.0

    def run_rounds(self, rounds: int, timeout: float = 120.0):
        """Drive `rounds` synchronous steps across all alive nodes."""
        for _ in range(rounds):
            alive = [i for i, np_ in self.nodes.items() if np_.alive]
            target = {i: self.nodes[i].last_step + 1 for i in alive}
            for i in alive:
                self.nodes[i].conn.send("go")
            t0 = time.time()
            pending = set(alive)
            while pending:
                if time.time() - t0 > timeout:
                    raise TimeoutError("round did not complete")
                for i in list(pending):
                    self.pump(i, 0.01)
                    if self.nodes[i].last_step >= target[i]:
                        pending.discard(i)

    def kill_trainer(self, node: int):
        """Software failure: trainer dies, SMP survives (orphaned)."""
        np_ = self.nodes[node]
        self.pump(node)
        os.kill(np_.proc.pid, signal.SIGKILL)
        np_.proc.join()
        np_.alive = False

    def kill_node(self, node: int):
        """Hardware failure: trainer + SMP die, volatile memory wiped."""
        np_ = self.nodes[node]
        self.pump(node)
        os.kill(np_.proc.pid, signal.SIGKILL)
        np_.proc.join()
        if np_.smp_pid:
            try:
                os.kill(np_.smp_pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        ReadOnlyNode.unlink_node(self.run, node)
        np_.alive = False

    def checkpoint(self, timeout: float = 60.0):
        """Ask every alive trainer's SMP to persist (REFT-Ckpt)."""
        for i, np_ in self.nodes.items():
            if np_.alive:
                np_.conn.send("ckpt")  # analyze: ok ANZ003 — coordinator is single-threaded
        t0 = time.time()
        while time.time() - t0 < timeout:
            if all(np_.last_ckpt >= 0 for np_ in self.nodes.values()
                   if np_.alive):
                return
            for i, np_ in self.nodes.items():
                if np_.alive:
                    self.pump(i, 0.01)
        raise TimeoutError("checkpoint acks missing")

    def kill_smp(self, node: int):
        """SMP-only crash (trainer keeps running; snapshots degrade)."""
        np_ = self.nodes[node]
        if np_.smp_pid:
            os.kill(np_.smp_pid, signal.SIGKILL)

    # --------------------------------------------------------- recovery
    def recover(self, target=None):
        """3-tier recovery via the shared ladder. (state, step, tier).
        The per-phase `LoadStats` land on `self.last_load_stats`."""
        from repro_torch.api.backends import reft_recovery_ladder
        res = reft_recovery_ladder(self.run, self.n, self.total_bytes,
                                   self.template, list(range(self.n)),
                                   self.ckpt_dir, target=target)
        self.last_load_stats = res.load
        return res.state, res.step, res.tier

    def restart_node(self, node: int, state: dict):
        """Elastic replacement node resumes from the recovered state."""
        import pickle
        self._cleanup_node_procs(node)
        self._spawn(node, start_state_blob=pickle.dumps(as_numpy(state)))

    def _cleanup_node_procs(self, node: int):
        np_ = self.nodes.get(node)
        if np_ is None:
            return
        if np_.proc.is_alive():
            os.kill(np_.proc.pid, signal.SIGKILL)
            np_.proc.join()
        if np_.smp_pid:
            try:
                os.kill(np_.smp_pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        ReadOnlyNode.unlink_node(self.run, node)

    def expected_state(self, step: int) -> dict:
        return state_at(self.seed, step, self.nbytes)

    def close(self):
        for i in list(self.nodes):
            self._cleanup_node_procs(i)
