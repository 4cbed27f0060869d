"""The port's analyzer (`repro_torch.analyze`: lint, cli, __main__)
against the reference's (`repro.analyze`): the same findings, rule for
rule and line for line, on every lint snippet of tests/test_analyze.py
(positive, negative and pragma cases, copied here); the same findings and
suppressed counts over both packages' trees; the same model-check result;
and the strict gate over the port exits 0 with JAX blocked, as the card
machine runs it."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analyze import lint as jlint
from repro.analyze.protocol import CheckConfig as JCheckConfig
from repro.analyze.protocol import model_check as jmodel_check
from repro_torch.analyze import lint as tlint
from repro_torch.analyze.protocol import CheckConfig, model_check

ROOT = Path(__file__).resolve().parents[1]

# tests/test_analyze.py::TestLintRules, snippet for snippet
SNIPPETS = {
    "anz001 list default": "def f(x=[]):\n    return x\n",
    "anz001 dict() default": "def f(x=dict()):\n    return x\n",
    "anz001 shared instance": "def f(cfg=ReftConfig()):\n    return cfg\n",
    "anz001 dataclass field": ("from dataclasses import dataclass\n"
                               "@dataclass\n"
                               "class C:\n"
                               "    xs: list = []\n"),
    "anz001 negative": ("from dataclasses import dataclass, field\n"
                        "@dataclass\n"
                        "class C:\n"
                        "    xs: list = field(default_factory=list)\n"
                        "    n: int = 3\n"
                        "def f(x=None, y=(), z=3):\n"
                        "    return x\n"),
    "anz001 pragma": "def f(x=[]):  # analyze: ok ANZ001\n    return x\n",
    "anz002 sleep under lock": ("def f(self):\n"
                                "    with self._lock:\n"
                                "        time.sleep(1)\n"),
    "anz002 recv under lock": ("def f(self):\n"
                               "    with self._rx_lock:\n"
                               "        msg = conn.recv()\n"),
    "anz002 negative": ("def f(self):\n"
                        "    with self._lock:\n"
                        "        x = 1\n"
                        "    time.sleep(1)\n"
                        "    with self._cond:\n"
                        "        self._cond.wait(1.0)\n"),
    "anz002 pragma": ("def f(self):\n"
                      "    with self._lock:\n"
                      "        # analyze: ok ANZ002\n"
                      "        time.sleep(1)\n"),
    "anz003 send outside lock": "def f(conn):\n    conn.send(('x',))\n",
    "anz003 negative": ("def f(self):\n"
                        "    with self._tx_lock:\n"
                        "        self._conn.send(('x',))\n"),
    "anz003 non-pipe receiver": ("def f(sock_like):\n"
                                 "    requests.send(x)\n"),
    "anz003 pragma": ("def f(conn):\n"
                      "    conn.send(('x',))  # analyze: ok ANZ003\n"),
    "anz004 tmp without finally": ("def f(path):\n"
                                   "    tmp = path + '.tmp'\n"
                                   "    with open(tmp, 'w') as fh:\n"
                                   "        fh.write('x')\n"),
    "anz004 negative": ("def f(path):\n"
                        "    tmp = path + '.tmp'\n"
                        "    try:\n"
                        "        with open(tmp, 'w') as fh:\n"
                        "            fh.write('x')\n"
                        "        os.replace(tmp, path)\n"
                        "    finally:\n"
                        "        try:\n"
                        "            os.unlink(tmp)\n"
                        "        except FileNotFoundError:\n"
                        "            pass\n"),
    "anz004 read": ("def f(tmp):\n"
                    "    with open(tmp, 'r') as fh:\n"
                    "        fh.read()\n"),
    "anz004 pragma": ("def f(tmp):\n"
                      "    fh = open(tmp, 'w')  # analyze: ok ANZ004\n"),
    "anz005 bare except": "try:\n    x()\nexcept:\n    pass\n",
    "anz005 negative": "try:\n    x()\nexcept Exception:\n    pass\n",
    "anz005 pragma": ("try:\n    x()\nexcept:  # analyze: ok ANZ005\n"
                      "    pass\n"),
    "anz006 time in planner": ("def plan_scenarios(seed):\n"
                               "    return time.time()\n"),
    "anz006 uuid in planner": ("def plan_x(seed):\n"
                               "    import uuid\n"
                               "    return uuid.uuid4()\n"),
    "anz006 negative": ("def plan_scenarios(seed):\n"
                        "    rng = np.random.default_rng(seed)\n"
                        "    return rng.random()\n"
                        "def helper():\n"
                        "    return time.time()\n"),
    "anz006 pragma": ("def plan_x(seed):\n"
                      "    return time.time()  # analyze: ok ANZ006\n"),
    "anz007 sleep in loop": ("def f():\n"
                             "    while not done():\n"
                             "        time.sleep(0.1)\n"),
    "anz007 negative": "def f():\n    time.sleep(0.1)\n",
    "anz007 pragma previous line": ("def f():\n"
                                    "    while not done():\n"
                                    "        # analyze: ok ANZ007\n"
                                    "        time.sleep(0.1)\n"),
}


def _key(findings):
    return [(f.rule, f.path, f.line, f.msg) for f in findings]


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_lint_source_matches_reference(name):
    src = SNIPPETS[name]
    jsup, tsup = [], []
    want = jlint.lint_source(src, "snippet.py", jsup)
    got = tlint.lint_source(src, "snippet.py", tsup)
    assert _key(got) == _key(want)
    assert _key(tsup) == _key(jsup)
    assert want or jsup or "negative" in name or "read" in name or \
        "non-pipe" in name, "a positive or pragma case must find something"


def test_rule_catalogs_are_equal():
    assert tlint.RULES == jlint.RULES


@pytest.mark.parametrize("tree", ["src/repro", "src/repro_torch"])
def test_lint_paths_matches_reference(tree):
    jsup, tsup = [], []
    want = jlint.lint_paths([ROOT / tree], jsup)
    got = tlint.lint_paths([ROOT / tree], tsup)
    assert _key(got) == _key(want)
    assert _key(tsup) == _key(jsup)


def test_model_check_matches_reference():
    want = jmodel_check(JCheckConfig())
    got = model_check(CheckConfig())
    assert (got.states, got.transitions, got.violations, got.wedges,
            got.complete) == (want.states, want.transitions,
                              want.violations, want.wedges, want.complete)
    assert got.ok


def test_strict_gate_over_the_port_exits_0_without_jax(tmp_path):
    """`python -m repro_torch.analyze --strict src/repro_torch`, with
    `import jax` made to fail, and its JSON summary."""
    block = tmp_path / "block"
    block.mkdir()
    for name in ("jax", "jaxlib"):
        (block / f"{name}.py").write_text(
            "raise ImportError('jax is not installed here')\n")
    out = tmp_path / "analyze.json"
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(block), str(ROOT / "src")]))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analyze",
                        "--strict", "--json", str(out), "src/repro_torch"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "analyze: 0 findings" in r.stderr
    assert '"findings": 0' in out.read_text()
