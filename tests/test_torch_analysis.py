"""The port's static auditor (``repro_torch.analysis``) held against the
reference's finding for finding.

Every rule's fixture (the snippets of the reference's
``tests/test_analysis.py``, each suppression form among them) goes through
both ``analyze_code``s, with ``src/repro/`` paths mapped to
``src/repro_torch/``: the ``(rule, line, message)`` lists must be equal.
The port's auditor reads the port's mirror registries, finds nothing in
the port's own tree, and its CLI prints and exits as the reference's."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from test_torch_sim_parity import PORT, REF

ROOT = pathlib.Path(__file__).resolve().parents[1]

_TERMINAL_PAIRS = {
    f"mir104-paired-{term.lower()}": (f"""\
        def drop(req, led):
            req.state = RequestState.{term}
            led.state[req.row] = {term}
    """, "fixture.py", None) for term in ("REJECTED", "SHED", "EXPIRED", "FINISHED")}

_FINISH = """\
    def finish(req):
        req.state = RequestState.FINISHED
"""
_WALL_CLOCK = """\
    import time

    def stamp():
        return time.time()
"""
_FILTERED = """\
    import os

    def finish(req):
        req.state = RequestState.FINISHED
"""

# id -> (code, path, rules)
FIXTURES = {
    "mir101-unsynced": ("""\
        def finish(req, t):
            req.state = RequestState.FINISHED
            req.finish_time = t
    """, "fixture.py", None),
    "mir101-paired": ("""\
        def finish(req, led, t):
            req.state = RequestState.FINISHED
            led.state[req.row] = FINISHED
            req.finish_time = t
            led.finish_time[req.row] = t
    """, "fixture.py", None),
    "mir101-instance-state": ("""\
        def activate(inst):
            inst.state = InstanceState.ACTIVE
    """, "fixture.py", None),
    "mir102-scalar": ("""\
        def grow(self):
            self._n_dec += 1
    """, "fixture.py", None),
    "mir102-scalar-synced": ("""\
        def grow(self):
            self._n_dec += 1
            self._sync_plane()
    """, "fixture.py", None),
    "mir102-container": ("""\
        def swap(self, i, seq):
            self.running[i] = seq
    """, "fixture.py", None),
    "mir102-container-synced": ("""\
        def swap(self, i, seq):
            self.running[i] = seq
            self._sync_plane()
    """, "fixture.py", None),
    "mir102-alloc-free-clear-del": ("""\
        def churn(self, plane, inst):
            inst.active = True
            self.running.clear()
            del self.running[0]
            plane.alloc(inst)
        def lone(self):
            self.running.clear()
    """, "fixture.py", None),
    "mir103-payload": ("""\
        def push(self, i, req):
            self.req_objs[i] = req
            self.seq[i] = 1
            self.row[i] = req.row
        def clear(self, i):
            self.req_objs[i] = None
        def full(self, i, req):
            self.req_objs[i] = req
            self.seq[i] = 1
            self.arrival[i] = 0.0
            self.deadline[i] = 1.0
            self.row[i] = req.row
    """, "fixture.py", None),
    "mir104-mismatch": ("""\
        def refuse(req, led):
            req.state = RequestState.REJECTED
            led.state[req.row] = FINISHED
    """, "fixture.py", None),
    **_TERMINAL_PAIRS,
    "mir104-suppressed": ("""\
        def refuse(req, led):
            req.state = RequestState.SHED  # mirror-sync: ok(test)
            led.state[req.row] = FINISHED
    """, "fixture.py", None),
    "mir-scope-sim": (_FINISH, "src/repro/sim/cluster.py", None),
    "mir-scope-serving": (_FINISH, "src/repro/serving/engine.py", None),
    "mir-scope-launch": (_FINISH, "src/repro/launch/serve.py", None),
    "mir-init-exempt": ("""\
        def __init__(self):
            self.active = False
    """, "fixture.py", None),
    "det201": ("""\
        import random
        import numpy as np

        def jitter():
            a = random.random()
            b = np.random.rand(4)
            rng = np.random.default_rng(0)
            c = rng.random()
            d = random.Random(3).random()
            return a, b, c, d
    """, "fixture.py", None),
    "det202-sim": (_WALL_CLOCK, "src/repro/sim/foo.py", None),
    "det202-scripts": (_WALL_CLOCK, "scripts/foo.py", None),
    "det202-benchmarks": (_WALL_CLOCK, "benchmarks/foo.py", None),
    "det202-datetime": ("""\
        import datetime

        def stamp():
            return datetime.datetime.now(), datetime.date.today()
    """, "fixture.py", None),
    "det203": ("""\
        def review(a, b):
            for k in set(a) | set(b):
                print(k)
            for k in sorted(set(a) | set(b)):
                print(k)
            out = [x for x in {1, 2, 3}]
            return out
    """, "fixture.py", None),
    "det204": ("""\
        import heapq

        def push(heap, t, inst, seq):
            heapq.heappush(heap, inst)
            heapq.heappush(heap, (t, inst))
            heapq.heappush(heap, (t, next(seq), inst))
            heapq.heappush(heap, (t, inst._epoch, inst))
    """, "fixture.py", None),
    "det205": ("""\
        def poll(inst, now):
            if inst.ready_time <= now:
                fire(inst)
            if inst.ready_time <= now + 1e-9:
                fire(inst)
            if inst.ready_time != now:
                pass
            if t > inst.prefill_done_t:
                pass
    """, "fixture.py", None),
    "lint301": ("""\
        import os
        import sys
        from math import ceil, floor

        def up(x):
            return ceil(x), sys.argv
    """, "fixture.py", None),
    "lint301-init-reexport": ("import os\n", "pkg/__init__.py", None),
    "lint302": ("""\
        def push(x, acc=[]):
            acc.append(x)
            return acc

        def safe(x, acc=None):
            return acc

        def kw(x, *, opts=dict()):
            return opts
    """, "fixture.py", None),
    "suppress-line": ("""\
        def finish(req, t):
            req.state = RequestState.FINISHED  # mirror-sync: ok(test)
            req.finish_time = t
    """, "fixture.py", None),
    "suppress-standalone-comment": ("""\
        def poll(inst, now):
            # repro-lint: ok(DET205, clamped at call sites)
            if inst.ready_time <= now:
                fire(inst)
    """, "fixture.py", None),
    "suppress-def-line": ("""\
        def finish(req, t):  # mirror-sync: ok(caller settles the ledger)
            req.state = RequestState.FINISHED
            req.finish_time = t
    """, "fixture.py", None),
    "suppress-module": ("""\
        # mirror-sync: module ok(no columnar mirrors in this module)
        def finish(req, t):
            req.state = RequestState.FINISHED
            req.finish_time = t
    """, "fixture.py", None),
    "suppress-wrong-rule": ("""\
        def poll(inst, now):
            # repro-lint: ok(DET201, wrong rule id)
            if inst.ready_time <= now:
                fire(inst)
    """, "fixture.py", None),
    "rules-mir": (_FILTERED, "fixture.py", ["MIR"]),
    "rules-lint301": (_FILTERED, "fixture.py", ["LINT301"]),
    "rules-det-prefix": (_WALL_CLOCK, "src/repro/sim/foo.py", ["DET"]),
}


def _port_path(path):
    return path.replace("src/repro/", "src/repro_torch/")


def _findings(P, name):
    code, path, rules = FIXTURES[name]
    if P is PORT:
        path = _port_path(path)
    found = P.analysis.analyze_code(textwrap.dedent(code), path=path, rules=rules)
    assert all(f.path == path for f in found)
    return [(f.rule, f.line, f.message) for f in found]


@pytest.mark.parametrize("name", list(FIXTURES))
def test_every_fixture_gives_the_reference_findings(name):
    ref = _findings(REF, name)
    assert _findings(PORT, name) == ref


def test_the_fixtures_exercise_every_rule():
    """The fixtures are no vacuous match: together they trip every rule of
    the catalogue, and the suppressed or paired ones trip none."""
    fired = {rule for name in FIXTURES for rule, _, _ in _findings(PORT, name)}
    assert fired == {"MIR101", "MIR102", "MIR103", "MIR104", "DET201", "DET202",
                     "DET203", "DET204", "DET205", "LINT301", "LINT302"}
    clean = ["mir101-paired", "mir101-instance-state", "mir102-scalar-synced",
             "mir102-container-synced", "mir104-suppressed", "mir-scope-launch",
             "mir-init-exempt", "det202-scripts", "det202-benchmarks",
             "lint301-init-reexport", "suppress-standalone-comment",
             "suppress-def-line", "suppress-module", *_TERMINAL_PAIRS]
    assert {name: _findings(PORT, name) for name in clean} == {name: [] for name in clean}


def test_the_mirror_rules_are_scoped_to_the_port():
    """Inside the port only ``sim`` and ``serving`` hold mirrors; a reference
    path is outside the port's package and gets every rule."""
    code = textwrap.dedent(_FINISH)
    assert PORT.analysis.analyze_code(code, path="src/repro_torch/sim/cluster.py")
    assert PORT.analysis.analyze_code(code, path="src/repro_torch/serving/engine.py")
    assert not PORT.analysis.analyze_code(code, path="src/repro_torch/launch/serve.py")
    assert not PORT.analysis.analyze_code(code, path="src/repro_torch/obs/export.py")
    assert PORT.analysis.analyze_code(code, path="src/repro/launch/serve.py")


def test_the_checks_read_the_ports_registries():
    checks = PORT.checks
    assert checks.LEDGER_MIRRORS is PORT.ledger.LEDGER_MIRRORS
    assert checks.PLANE_MIRRORS is PORT.cluster.PLANE_MIRRORS
    assert checks.PLANE_CONTAINER_MIRRORS is PORT.cluster.PLANE_CONTAINER_MIRRORS
    assert checks.QUEUE_KEY_COLUMNS is PORT.queue.QUEUE_KEY_COLUMNS
    assert checks.LEDGER_MIRRORS is not REF.ledger.LEDGER_MIRRORS
    assert checks.PLANE_MIRRORS is not REF.cluster.PLANE_MIRRORS
    assert checks._MIRROR_SCOPES == ("repro_torch/sim", "repro_torch/serving")


def test_the_ports_tree_is_clean():
    files = PORT.analysis.iter_py_files([str(ROOT / "src" / "repro_torch")])
    assert any(f.endswith(os.path.join("sim", "fleet.py")) for f in files)
    findings = PORT.analysis.run_analysis([str(ROOT / "src" / "repro_torch")])
    assert findings == [], "\n".join(str(f) for f in findings)


def _cli(P, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", f"{P.root}.analysis", *args],
                          capture_output=True, text=True, env=env)


def test_the_cli_prints_and_exits_as_the_reference(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nimport random\n\ndef f(x=[]):\n    return random.random()\n")
    good = tmp_path / "good.py"
    good.write_text("X = 1\n")
    for args in ([str(bad), "--json"], [str(bad), "--json", "--rules", "DET,LINT302"],
                 [str(tmp_path), "--json"]):
        ref, port = _cli(REF, *args), _cli(PORT, *args)
        assert port.returncode == ref.returncode == 1
        assert json.loads(port.stdout) == json.loads(ref.stdout) != []
    ref, port = _cli(REF, str(bad)), _cli(PORT, str(bad))
    assert port.returncode == ref.returncode == 1 and port.stdout == ref.stdout
    ref, port = _cli(REF, str(good)), _cli(PORT, str(good))
    assert port.returncode == ref.returncode == 0 and port.stdout == ref.stdout == ""
    ref, port = _cli(REF), _cli(PORT)                 # no path: a usage error
    assert port.returncode == ref.returncode == 2
