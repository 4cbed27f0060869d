"""Repo-specific AST lint rules (repro_torch.analyze part 1).

The twin of `repro/analyze/lint.py`: the same rules, pragma syntax and
findings, stdlib only. These are not style checks — each rule encodes a
bug class this codebase has actually shipped or a discipline the
concurrency design depends on:

  ANZ001  mutable default argument / dataclass field.  A shared
          ``ReftConfig()`` default once aliased config across
          checkpointers; any list/dict/set display, ``dict()``-style call or
          CamelCase constructor call in a parameter default or a
          non-``field(default_factory=...)`` dataclass field is flagged.
  ANZ002  blocking call while a lock is statically held: ``time.sleep``,
          thread ``.join()``, pipe ``.recv()``, ``open()``/``os.fsync``
          lexically inside a ``with <lock-like>:`` body stalls every
          other actor contending that lock.  (``Condition.wait`` is
          exempt — it releases.)
  ANZ003  pipe send outside the owning tx-lock: ``conn.send`` from two
          threads interleaves pickled frames; every send must sit inside
          a ``with <lock>:`` (the SMP's demux depends on it).
  ANZ004  temp-file write without a ``finally`` unlink: a ``tmp``-named
          path opened outside a try/finally that unlinks it leaks the
          partial file on error (a tmp-file leak once shipped).
  ANZ005  bare ``except:`` — swallows KeyboardInterrupt/SystemExit.
  ANZ006  nondeterminism in a seeded planner: wall-clock/uuid/global-RNG
          calls inside ``plan_*`` functions break replayable failure
          schedules (``inject.plan_scenarios`` must be seed-pure).
  ANZ007  ``time.sleep`` inside a ``while`` loop — a polling loop; use
          events/conditions, or justify with a pragma.

Suppression: append ``# analyze: ok RULE-ID[, RULE-ID...]`` to the
finding line (or the line directly above).  Pragmas are deliberate,
reviewable allowlists — each one should say why in the surrounding code.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

__all__ = ["Finding", "RULES", "lint_source", "lint_file", "lint_paths",
           "iter_py"]

RULES: Dict[str, str] = {
    "ANZ001": "mutable default argument / dataclass field",
    "ANZ002": "blocking call while a lock is held",
    "ANZ003": "pipe send outside the owning tx-lock",
    "ANZ004": "temp-file write without a finally unlink",
    "ANZ005": "bare except",
    "ANZ006": "nondeterminism in a seeded planner",
    "ANZ007": "time.sleep polling loop",
}

_PRAGMA = re.compile(r"#\s*analyze:\s*ok\s+([A-Z0-9*,\s]+)")
_LOCKY = re.compile(r"(lock|mutex|cond|guard|sem4lock|^_?mu$)", re.I)
_PIPEY = re.compile(r"(^|_)(conn|pipe|child|sock)$")
_TMPY = re.compile(r"(^|[._])tmp", re.I)
# wall-clock / entropy calls that break seeded replay
_NONDET = re.compile(
    r"(^|\.)time\.(time|time_ns|monotonic)$|"
    r"(^|\.)datetime\.(now|utcnow|today)$|"
    r"(^|\.)uuid\.uuid[14]$|"
    r"^random\.|"
    r"^(np|numpy)\.random\.(?!default_rng|Generator|SeedSequence)")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.msg}"


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name for Name/Attribute chains ('' otherwise)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        return _dotted(node.func)
    else:
        return ""
    return ".".join(reversed(parts))


def _tail(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _is_mutable_default(node: ast.AST) -> Optional[str]:
    """Why a default expression is a shared-mutable hazard, or None."""
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return f"{type(node).__name__.lower()} display"
    if isinstance(node, ast.Call):
        fn = _tail(_dotted(node.func))
        if fn in ("dict", "list", "set", "bytearray", "defaultdict",
                  "deque", "Counter", "OrderedDict"):
            return f"{fn}() call"
        # CamelCase constructor: one instance shared by every call /
        # every dataclass instance (the shared ReftConfig() bug class)
        if fn[:1].isupper() and not fn.isupper():
            return f"shared {fn}() instance"
    return None


def _is_default_factory_field(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and _tail(_dotted(node.func)) == "field"
            and any(kw.arg == "default_factory" for kw in node.keywords))


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []
        self._locks: List[str] = []        # names of with-held locks
        self._whiles = 0
        self._finally_unlink = 0           # try/finally-with-unlink depth
        self._funcs: List[str] = []
        self._dataclass = 0

    def _add(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(
            Finding(rule, self.path, getattr(node, "lineno", 0), msg))

    # ------------------------------------------------------------ defaults
    def _check_arg_defaults(self, node) -> None:
        a = node.args
        for d in list(a.defaults) + list(a.kw_defaults):
            if d is None:
                continue
            why = _is_mutable_default(d)
            if why:
                self._add("ANZ001", d,
                          f"mutable default in {node.name}(): {why}")

    def visit_FunctionDef(self, node):
        self._check_arg_defaults(node)
        self._funcs.append(node.name)
        self.generic_visit(node)
        self._funcs.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        # lambda defaults share the same hazard
        for d in list(node.args.defaults) + list(node.args.kw_defaults):
            if d is not None and _is_mutable_default(d):
                self._add("ANZ001", d, "mutable default in lambda")
        self.generic_visit(node)

    def visit_ClassDef(self, node):
        is_dc = any(
            _tail(_dotted(dec)) == "dataclass" for dec in node.decorator_list)
        if is_dc:
            for stmt in node.body:
                val = None
                if isinstance(stmt, ast.AnnAssign):
                    val = stmt.value
                elif isinstance(stmt, ast.Assign):
                    val = stmt.value
                if val is None or _is_default_factory_field(val):
                    continue
                why = _is_mutable_default(val)
                if why:
                    self._add(
                        "ANZ001", val,
                        f"mutable dataclass field default in {node.name}: "
                        f"{why} — use field(default_factory=...)")
        self.generic_visit(node)

    # ---------------------------------------------------------- lock scope
    def visit_With(self, node):
        held = []
        for item in node.items:
            name = _tail(_dotted(item.context_expr))
            if name and _LOCKY.search(name):
                held.append(name)
        self._locks.extend(held)
        for stmt in node.body:
            self.visit(stmt)
        for item in node.items:        # with-expressions themselves
            self.visit(item.context_expr)
        if held:
            del self._locks[-len(held):]

    visit_AsyncWith = visit_With

    def visit_While(self, node):
        self._whiles += 1
        self.generic_visit(node)
        self._whiles -= 1

    def visit_Try(self, node):
        for h in node.handlers:
            if h.type is None:
                self._add("ANZ005", h, "bare except")
        has_unlink = any(
            _tail(_dotted(c.func)) in ("unlink", "remove", "_cleanup_tmp")
            for stmt in node.finalbody
            for c in ast.walk(stmt) if isinstance(c, ast.Call))
        if has_unlink:
            self._finally_unlink += 1
            self.generic_visit(node)
            self._finally_unlink -= 1
        else:
            self.generic_visit(node)

    # --------------------------------------------------------------- calls
    def visit_Call(self, node):
        name = _dotted(node.func)
        tailn = _tail(name)

        # ANZ002: blocking while a lock is held (lexically)
        if self._locks:
            blocking = None
            if name in ("time.sleep", "sleep"):
                blocking = "time.sleep"
            elif tailn == "recv":
                blocking = f"{name}()"
            elif tailn == "fsync":
                blocking = "fsync"
            elif name == "open":
                blocking = "open()"
            elif tailn == "join" and self._thread_join(node):
                blocking = f"{name}()"
            if blocking:
                self._add("ANZ002",
                          node, f"{blocking} while holding "
                          f"{'/'.join(self._locks)}")

        # ANZ003: pipe send must sit under a tx lock
        if (tailn == "send" and isinstance(node.func, ast.Attribute)
                and _PIPEY.search(_tail(_dotted(node.func.value)) or "")
                and not self._locks):
            self._add("ANZ003", node,
                      f"{name}() outside any lock — concurrent senders "
                      f"interleave pickled frames")

        # ANZ004: tmp-file write without finally-unlink protection
        if name == "open" and node.args and not self._finally_unlink:
            mode = ""
            if len(node.args) > 1 and isinstance(node.args[1], ast.Constant):
                mode = str(node.args[1].value)
            target = node.args[0]
            tname = (_dotted(target) or
                     (target.value if isinstance(target, ast.Constant)
                      and isinstance(target.value, str) else ""))
            if _TMPY.search(str(tname)) and ("w" in mode or "x" in mode
                                             or not mode):
                self._add("ANZ004", node,
                          f"write to tmp path {tname!r} without a "
                          f"finally-unlink")

        # ANZ006: nondeterminism inside plan_* (seeded planners)
        if any(f.startswith("plan_") for f in self._funcs):
            if name and _NONDET.search(name):
                self._add("ANZ006", node,
                          f"{name}() in seeded planner "
                          f"{[f for f in self._funcs if f.startswith('plan_')][-1]}()")

        # ANZ007: sleep inside a while loop = polling
        if self._whiles and name in ("time.sleep", "sleep"):
            self._add("ANZ007", node,
                      "time.sleep in a while loop (polling) — prefer an "
                      "Event/Condition wait")

        self.generic_visit(node)

    @staticmethod
    def _thread_join(node: ast.Call) -> bool:
        """Discriminate thread/process .join() from str.join(iterable):
        str.join always takes exactly one non-numeric positional arg."""
        if node.keywords:
            return any(kw.arg == "timeout" for kw in node.keywords)
        if not node.args:
            return True
        return (len(node.args) == 1
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, (int, float)))


def _pragmas(source: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = _PRAGMA.search(line)
        if m:
            out[i] = {t.strip() for t in m.group(1).replace(",", " ").split()
                      if t.strip()}
    return out


def lint_source(source: str, path: str = "<string>",
                suppressed_out: Optional[list] = None) -> List[Finding]:
    """Lint one module's source; pragma-suppressed findings are dropped
    (and appended to `suppressed_out` when given, for reporting)."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("ANZ000", path, e.lineno or 0,
                        f"syntax error: {e.msg}")]
    v = _Visitor(path)
    v.visit(tree)
    pragmas = _pragmas(source)
    kept: List[Finding] = []
    for f in sorted(v.findings, key=lambda f: (f.line, f.rule)):
        ok = pragmas.get(f.line, set()) | pragmas.get(f.line - 1, set())
        if f.rule in ok or "*" in ok:
            if suppressed_out is not None:
                suppressed_out.append(f)
            continue
        kept.append(f)
    return kept


def lint_file(path: Path, suppressed_out: Optional[list] = None
              ) -> List[Finding]:
    return lint_source(path.read_text(encoding="utf-8"), str(path),
                       suppressed_out)


def iter_py(root: Path) -> Iterable[Path]:
    if root.is_file():
        yield root
        return
    for p in sorted(root.rglob("*.py")):
        if "__pycache__" not in p.parts:
            yield p


def lint_paths(paths: Iterable[Path],
               suppressed_out: Optional[list] = None) -> List[Finding]:
    out: List[Finding] = []
    for root in paths:
        for p in iter_py(Path(root)):
            out.extend(lint_file(p, suppressed_out))
    return out
