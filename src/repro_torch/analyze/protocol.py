"""SMP protocol model checker + runtime trace validator (part 3).

The trainer <-> SMP wire protocol (`core/smp.py`) is the reliability
core of the reproduction: a demultiplexed, seq-tagged pipe carrying
``ready -> begin -> bucket* -> end`` snapshot flights interleaved with
async ``persist``/``persisted`` exchanges, refcounted buffer pins and
stale-seq discard.  PR 5's desync and PR 8's close-during-flight race
both lived here.  This module encodes that FSM once, as data, and uses
it twice:

  * `TraceValidator` — a cheap runtime monitor `SMPHandle` feeds every
    sent/received message (behind ``ReftConfig.trace_protocol``), plus a
    `ServerValidator` for the SMP-side pin/selection invariants.  Any
    deviation raises `ProtocolViolation` loudly instead of wedging.
  * `model_check` — an explicit-state bounded model checker that
    exhaustively enumerates interleavings of snapshots, in-flight
    persists, persist timeouts, a stop and an SMP death against the SAME
    flight table, proving no reachable wedge / double-unpin / torn
    persist / desync within the bound.

Reading a counterexample: each violation carries ``trace`` — the exact
action sequence (``t:begin#1``, ``s:persist#2``, ``w:done#2`` ...) from
the initial state to the bad transition; ``t:`` = trainer, ``s:`` = SMP
message loop, ``w:`` = SMP persist worker.  Replay it mentally against
`core/smp.py` — every label maps 1:1 to a code path.
"""
from __future__ import annotations

import threading
from collections import deque, namedtuple
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "ProtocolViolation", "FLIGHT_FSM", "TraceValidator", "ServerValidator",
    "CheckConfig", "CheckResult", "model_check",
]


class ProtocolViolation(RuntimeError):
    """A message that the SMP protocol FSM does not allow."""


# --------------------------------------------------------------- the table
# Snapshot-flight phase machine, keyed (phase, op) -> next phase.  This is
# the single source of truth: TraceValidator gates trainer->SMP sends with
# it and the model checker gates the abstract trainer's actions with it.
# `persist`/`ping` are phase-preserving (they interleave with flights);
# `stop` is legal from idle (clean close) AND mid-flight (kill/teardown
# paths abandon the open flight by design).
FLIGHT_FSM: Dict[Tuple[str, str], str] = {
    ("start", "ready"): "idle",      # SMP hello, consumed once at come-up
    ("idle", "begin"): "open",
    ("open", "bucket"): "open",
    ("open", "end"): "idle",
    ("idle", "persist"): "idle",
    ("open", "persist"): "open",
    ("idle", "ping"): "idle",
    ("open", "ping"): "open",
    ("idle", "stop"): "stopped",
    ("open", "stop"): "stopped",
}


# ---------------------------------------------------------------- runtime
class TraceValidator:
    """Trainer-side runtime monitor for one `SMPHandle`'s pipe traffic.

    Thread-safe; every check is O(1) dict/deque work so it can stay on in
    CI (the micro benchmark gates its saving-path overhead at < 5%).
    Post-stop persist replies are tolerated (close-during-persist drains
    late ``persisted`` messages); everything else off-table raises.
    """

    def __init__(self, name: str = "smp", fsm: Optional[dict] = None,
                 strict: bool = True):
        self.name = name
        self.fsm = FLIGHT_FSM if fsm is None else fsm
        self.strict = strict
        self._mu = threading.Lock()
        self.phase = "start"
        self._open_step: Optional[int] = None
        self._expect_clean: deque = deque()
        self._expect_base: deque = deque()
        self._pings = 0
        self._outstanding: set = set()
        self._stale: set = set()
        self.events = 0
        self.violations: List[str] = []

    def _bad(self, why: str) -> None:
        msg = f"[{self.name}] protocol violation: {why}"
        self.violations.append(msg)
        if self.strict:
            raise ProtocolViolation(msg)

    # -- trainer -> SMP ---------------------------------------------------
    def tx(self, msg: tuple) -> None:
        op = msg[0]
        with self._mu:
            self.events += 1
            if op in ("begin", "bucket", "end", "stop", "ping", "persist"):
                nxt = self.fsm.get((self.phase, op))
                if nxt is None:
                    self._bad(f"tx {op!r} illegal in phase {self.phase!r}")
                    return
                self.phase = nxt
            if op == "begin":
                self._open_step = msg[1]
                if len(msg) > 2 and msg[2] is not None:
                    self._expect_base.append(msg[1])  # delta flight: ack due
            elif op == "end":
                if msg[1] != self._open_step:
                    self._bad(f"end step {msg[1]} != open step "
                              f"{self._open_step}")
                    return
                self._expect_clean.append(msg[1])
                self._open_step = None
            elif op == "persist":
                seq = msg[1]
                if seq in self._outstanding or seq in self._stale:
                    self._bad(f"persist seq {seq} reused")
                    return
                self._outstanding.add(seq)
            elif op == "ping":
                self._pings += 1

    # -- SMP -> trainer ---------------------------------------------------
    def rx(self, msg: tuple) -> None:
        tag = msg[0]
        with self._mu:
            self.events += 1
            if tag == "ready":
                nxt = self.fsm.get((self.phase, "ready"))
                if nxt is None:
                    self._bad(f"duplicate ready in phase {self.phase!r}")
                    return
                self.phase = nxt
            elif tag == "clean":
                if not self._expect_clean:
                    self._bad(f"clean({msg[1]}) with no flight ended")
                elif self._expect_clean[0] != msg[1]:
                    self._bad(f"clean({msg[1]}) but oldest ended flight is "
                              f"{self._expect_clean[0]} (desync)")
                else:
                    self._expect_clean.popleft()
            elif tag == "base":
                if not self._expect_base or self._expect_base[0] != msg[1]:
                    self._bad(f"base ack for step {msg[1]} never requested")
                else:
                    self._expect_base.popleft()
            elif tag == "pong":
                if self._pings <= 0:
                    self._bad("pong with no ping outstanding")
                else:
                    self._pings -= 1
            elif tag in ("persisted", "persist-error"):
                seq = msg[1]
                if seq in self._outstanding:
                    self._outstanding.discard(seq)
                elif seq in self._stale:
                    self._stale.discard(seq)   # tolerated late reply
                else:
                    self._bad(f"{tag} for unknown seq {seq} (desync)")
            elif tag == "protocol-error":
                self._bad(f"SMP-side: {msg[1]}")

    def mark_stale(self, seq: int) -> None:
        """persist_result timed out on `seq`: its late reply is legal."""
        with self._mu:
            self._outstanding.discard(seq)
            self._stale.add(seq)

    def snapshot(self) -> dict:
        with self._mu:
            return {"phase": self.phase, "events": self.events,
                    "outstanding": sorted(self._outstanding),
                    "stale": sorted(self._stale),
                    "violations": list(self.violations)}


class ServerValidator:
    """SMP-side invariants, checked in `_smp_main` when tracing is on.
    Methods return a violation string (the loop ships it back as a
    ``("protocol-error", text)`` message) or None."""

    @staticmethod
    def on_begin_select(selected: int, latest: int, pinned) -> Optional[str]:
        if selected == latest:
            return (f"begin selected buffer {selected} which is the "
                    f"published latest (would tear the clean snapshot)")
        if selected in pinned:
            return (f"begin selected pinned buffer {selected} "
                    f"(persist in flight would read torn bytes)")
        return None

    @staticmethod
    def on_unpin(idx: int, count_before: int) -> Optional[str]:
        if count_before <= 0:
            return f"double-unpin of buffer {idx} (refcount {count_before})"
        return None

    @staticmethod
    def on_persist_done(idx: int, job_step: int, buf_step: int,
                        buf_state_clean: bool) -> Optional[str]:
        if not buf_state_clean or buf_step != job_step:
            return (f"torn persist: buffer {idx} mutated under pin "
                    f"(job step {job_step}, buffer now step {buf_step}, "
                    f"clean={buf_state_clean})")
        return None


# ----------------------------------------------------------- model checker
# Abstract state.  Everything hashable/frozen so BFS can dedup.
#   tphase       trainer flight phase ("idle"/"open"/"stopped")
#   tstep        step of the current/next flight (1-based)
#   eclean       FIFO of steps whose `clean` ack is due
#   outst        frozenset of seqs awaiting persist replies
#   stale        frozenset of timed-out seqs (late replies legal)
#   fired        persists fired so far
#   q_ts / q_st  message queues trainer->SMP / SMP->trainer
#   dirty        SMP's open dirty buffer (-1 = none)
#   latest       published clean buffer (-1 = none)
#   bufs         3 x (step, state) with state in {"inv","dirty","clean"}
#   pins         3 x refcount
#   wq / wbusy   persist worker queue / running job (seq, idx, step)
#   alive        SMP process alive
#   sstop        SMP message loop saw `stop`
_S = namedtuple("_S", "tphase tstep eclean outst stale fired q_ts q_st "
                      "dirty latest bufs pins wq wbusy alive sstop")


@dataclass
class CheckConfig:
    max_snapshots: int = 2
    max_persists: int = 2
    allow_timeout: bool = True
    allow_death: bool = True
    fsm: Dict[Tuple[str, str], str] = field(
        default_factory=lambda: dict(FLIGHT_FSM))
    # fault-injection variants for self-tests of the checker itself:
    #   "unpin-before-pin"   persist skips the select-time pin (worker's
    #                        unpin then drives the refcount negative)
    #   "begin-picks-latest" begin may select the published buffer
    variant: Optional[str] = None
    max_states: int = 2_000_000


@dataclass
class CheckResult:
    states: int = 0
    transitions: int = 0
    violations: List[dict] = field(default_factory=list)
    wedges: List[dict] = field(default_factory=list)
    complete: bool = True     # False if max_states cut exploration short

    @property
    def ok(self) -> bool:
        return self.complete and not self.violations and not self.wedges


def _initial() -> _S:
    return _S("idle", 1, (), frozenset(), frozenset(), 0, (), (),
              -1, -1, ((0, "inv"),) * 3, (0, 0, 0), (), None, True, False)


def _succ(s: _S, cfg: CheckConfig):
    """Yield (label, next_state_or_None, violation_or_None)."""
    out = []

    def emit(label, **repl):
        out.append((label, s._replace(**repl), None))

    def bad(label, why):
        out.append((label, None, why))

    # ---- trainer actions (pipe usable only while the SMP lives) ----
    if s.alive:
        if (s.tstep <= cfg.max_snapshots
                and cfg.fsm.get((s.tphase, "begin"))):
            emit(f"t:begin#{s.tstep}",
                 tphase=cfg.fsm[(s.tphase, "begin")],
                 q_ts=s.q_ts + (("begin", s.tstep),))
        if s.tphase == "open" and cfg.fsm.get((s.tphase, "end")):
            emit(f"t:end#{s.tstep}",
                 tphase=cfg.fsm[(s.tphase, "end")],
                 tstep=s.tstep + 1,
                 eclean=s.eclean + (s.tstep,),
                 q_ts=s.q_ts + (("end", s.tstep),))
        if (s.fired < cfg.max_persists
                and cfg.fsm.get((s.tphase, "persist"))):
            seq = s.fired + 1
            emit(f"t:persist#{seq}",
                 fired=seq,
                 outst=s.outst | {seq},
                 q_ts=s.q_ts + (("persist", seq),))
        if cfg.fsm.get((s.tphase, "stop")):
            emit("t:stop",
                 tphase=cfg.fsm[(s.tphase, "stop")],
                 q_ts=s.q_ts + (("stop",),))
        if cfg.allow_timeout:
            for seq in sorted(s.outst):
                emit(f"t:timeout#{seq}",
                     outst=s.outst - {seq}, stale=s.stale | {seq})
        if s.q_st:                                   # trainer recv + demux
            msg, rest = s.q_st[0], s.q_st[1:]
            tag = msg[0]
            lbl = f"t:recv-{tag}" + (f"#{msg[1]}" if len(msg) > 1 else "")
            if tag == "clean":
                if not s.eclean or s.eclean[0] != msg[1]:
                    bad(lbl, f"desync: clean({msg[1]}) but expected "
                             f"{s.eclean[:1] or None}")
                else:
                    emit(lbl, eclean=s.eclean[1:], q_st=rest)
            elif tag in ("persisted", "persist-error"):
                seq = msg[1]
                if seq in s.outst:
                    emit(lbl, outst=s.outst - {seq}, q_st=rest)
                elif seq in s.stale:
                    emit(lbl, stale=s.stale - {seq}, q_st=rest)
                else:
                    bad(lbl, f"desync: {tag} for unknown seq {seq}")
            else:
                emit(lbl, q_st=rest)

    # ---- SMP message loop ----
    if s.alive and not s.sstop and s.q_ts:
        msg, rest = s.q_ts[0], s.q_ts[1:]
        op = msg[0]
        if op == "begin":
            step = msg[1]
            pinned = {i for i in range(3) if s.pins[i] > 0}
            cands = [i for i in range(3)
                     if i != s.latest and i not in pinned]
            if (cfg.variant == "begin-picks-latest" and s.latest >= 0
                    and s.latest not in pinned):
                cands = [s.latest]    # buggy selection: reuse the published
            if cands:          # else: pin_cond.wait — message stays queued
                sel = min(cands, key=lambda i: (s.bufs[i][0], i))
                why = ServerValidator.on_begin_select(sel, s.latest, pinned)
                if why:
                    bad(f"s:begin#{step}", why)
                else:
                    bufs = list(s.bufs)
                    bufs[sel] = (step, "dirty")
                    emit(f"s:begin#{step}", dirty=sel,
                         bufs=tuple(bufs), q_ts=rest)
        elif op == "end":
            step = msg[1]
            bufs = list(s.bufs)
            bufs[s.dirty] = (step, "clean")
            emit(f"s:end#{step}", latest=s.dirty, dirty=-1,
                 bufs=tuple(bufs), q_ts=rest,
                 q_st=s.q_st + (("clean", step),))
        elif op == "persist":
            seq = msg[1]
            if s.latest < 0:
                emit(f"s:persist#{seq}-nosnap", q_ts=rest,
                     q_st=s.q_st + (("persist-error", seq),))
            else:
                idx = s.latest
                pins = list(s.pins)
                if cfg.variant != "unpin-before-pin":
                    pins[idx] += 1
                emit(f"s:persist#{seq}", pins=tuple(pins), q_ts=rest,
                     wq=s.wq + ((seq, idx, s.bufs[idx][0]),))
        elif op == "stop":
            emit("s:stop", sstop=True, q_ts=rest)

    # ---- SMP persist worker (keeps draining after stop) ----
    if s.alive:
        if s.wbusy is None and s.wq:
            emit("w:take", wbusy=s.wq[0], wq=s.wq[1:])
        elif s.wbusy is not None:
            seq, idx, step = s.wbusy
            bstep, bstate = s.bufs[idx]
            lbl = f"w:done#{seq}"
            why = ServerValidator.on_persist_done(
                idx, step, bstep, bstate == "clean")
            if why is None:
                why = ServerValidator.on_unpin(idx, s.pins[idx])
            if why:
                bad(lbl, why)
            else:
                pins = list(s.pins)
                pins[idx] -= 1
                emit(lbl, pins=tuple(pins), wbusy=None,
                     q_st=s.q_st + (("persisted", seq, step),))

    # ---- SMP death (at most once; alive=False is absorbing) ----
    if cfg.allow_death and s.alive:
        emit("x:death", alive=False)

    return out


def _trace(parents: dict, state: _S, last_label: str) -> List[str]:
    labels = [last_label]
    while state in parents:
        state, lbl = parents[state]
        labels.append(lbl)
    return list(reversed(labels[:-1]))    # drop the root's None marker


def model_check(cfg: Optional[CheckConfig] = None) -> CheckResult:
    """BFS the bounded protocol state space; every reachable transition is
    taken, every invariant checked on the way."""
    cfg = cfg or CheckConfig()
    res = CheckResult()
    root = _initial()
    seen = {root}
    parents: Dict[_S, tuple] = {root: (None, None)}
    frontier = deque([root])
    while frontier:
        s = frontier.popleft()
        res.states += 1
        if res.states > cfg.max_states:
            res.complete = False
            break
        succ = _succ(s, cfg)
        if not succ:
            # terminal: fine unless the system still owes progress while
            # everything is healthy — that is a wedge (deadlock)
            owes = (s.tphase == "open" or s.eclean or s.outst
                    or s.q_ts or s.q_st or s.wq or s.wbusy is not None)
            if s.alive and owes:
                res.wedges.append(
                    {"state": s._asdict(),
                     "trace": _trace(parents, s, "<no enabled action>")})
            continue
        for label, nxt, why in succ:
            res.transitions += 1
            if why is not None:
                res.violations.append(
                    {"kind": why, "action": label,
                     "trace": _trace(parents, s, label)})
                continue
            if nxt not in seen:
                seen.add(nxt)
                parents[nxt] = (s, label)
                frontier.append(nxt)
    return res
