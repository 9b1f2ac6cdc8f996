"""AST rule implementations for the invariant auditor.

See :mod:`repro_torch.analysis` for the rule catalogue and suppression
syntax. The mirror registries are imported from the port's modules that
declare them (``repro_torch.sim.ledger``, ``repro_torch.sim.cluster``,
``repro_torch.serving.global_queue``) so the auditor can never drift from
the data structures it audits. The rule ids, messages and the order of the
findings are the reference's ``analysis.checks``; only the package the
mirror rules are scoped to is the port's.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding, Suppressions
from repro_torch.serving.global_queue import QUEUE_KEY_COLUMNS
from repro_torch.sim.cluster import PLANE_CONTAINER_MIRRORS, PLANE_MIRRORS
from repro_torch.sim.ledger import LEDGER_MIRRORS

# MIR103: the columnar queue's payload list — a subscript write to it
# must refresh every key column in the same function
_QUEUE_PAYLOAD = "req_objs"

# MIR104: terminal lifecycle writes (`req.state = RequestState.<T>` for a
# terminal T) must pair with a `state` column write mentioning the SAME
# terminal code name in the same function — MIR101 alone would accept a
# FINISHED column write as cover for a REJECTED object write.
_TERMINAL_NAMES = ("FINISHED", "REJECTED", "SHED", "EXPIRED")

# DET201: construction of *seeded* generators is the sanctioned idiom
_SEEDED_NP = frozenset({"default_rng", "Generator", "SeedSequence",
                        "RandomState", "PCG64", "Philox"})
_SEEDED_STDLIB = frozenset({"Random", "SystemRandom"})
# DET202: wall-clock reads (path-exempt under benchmarks/ and scripts/)
_WALL_CLOCK_TIME = frozenset({"time", "monotonic", "perf_counter",
                              "process_time"})
_CLOCK_EXEMPT_DIRS = frozenset({"benchmarks", "scripts"})
# DET204: identifier fragments that mark a total-order tiebreaker
_TIEBREAK_FRAGMENTS = ("seq", "id", "epoch", "kind")
# DET205: scheduled-event attributes vs current-time names
_EVENT_TIME_ATTRS = frozenset({"ready_time", "prefill_done_t"})
_CURRENT_TIME_NAMES = frozenset({"t", "now", "t_next", "t_arr"})
_CMP_OPS = (ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Eq)

_MIRROR_SCOPES = ("repro_torch/sim", "repro_torch/serving")
_INIT_FUNCS = frozenset({"__init__", "__post_init__"})


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _mirror_rules_apply(path: str) -> bool:
    """MIR rules audit the simulator/serving planes (where the mirrored
    structures live); files elsewhere in the ``repro_torch`` package are
    out of scope. Paths outside the package (fixtures, tmp files) get the full
    rule set so the auditor itself is testable."""
    norm = _norm(path)
    if "repro_torch/" not in norm:
        return True
    return any(scope in norm for scope in _MIRROR_SCOPES)


def _wall_clock_exempt(path: str) -> bool:
    parts = _norm(path).split("/")
    return any(part in _CLOCK_EXEMPT_DIRS for part in parts)


def _attr_chain(node: ast.AST) -> Tuple[str, ...]:
    """``np.random.rand`` -> ('np', 'random', 'rand'); () when the chain
    roots in something other than a plain name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _functions(tree: ast.Module) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Every node in ``fn``'s body excluding nested function bodies
    (each nested function gets its own mirror-pairing scope)."""
    stack: List[ast.AST] = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def _flat_targets(node: ast.AST) -> Iterator[ast.AST]:
    """Assignment targets of ``node``, tuple/list targets flattened."""
    if isinstance(node, ast.Assign):
        targets: Iterable[ast.AST] = node.targets
    elif isinstance(node, ast.AugAssign):
        targets = (node.target,)
    elif isinstance(node, ast.AnnAssign) and node.value is not None:
        targets = (node.target,)
    else:
        return
    stack = list(targets)
    while stack:
        tgt = stack.pop()
        if isinstance(tgt, (ast.Tuple, ast.List)):
            stack.extend(tgt.elts)
        else:
            yield tgt


def _mentions(node: ast.AST, name: str) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id == name:
            return True
        if isinstance(n, ast.Attribute) and n.attr == name:
            return True
    return False


class _Collector:
    def __init__(self, path: str, supp: Suppressions,
                 rules: Optional[Sequence[str]]):
        self.path = path
        self.supp = supp
        self.rules = tuple(rules) if rules is not None else None
        self.findings: List[Finding] = []

    def emit(self, rule: str, line: int, message: str,
             fn_line: Optional[int] = None) -> None:
        if self.rules is not None and not any(
                rule == r or rule.startswith(r) for r in self.rules):
            return
        if self.supp.suppressed(rule, line) \
                or self.supp.suppressed(rule, fn_line):
            return
        self.findings.append(Finding(rule, self.path, line, message))


# --------------------------------------------------------- mirror rules
def _check_mirrors(tree: ast.Module, out: _Collector) -> None:
    """MIR101/MIR102: every object write to a mirrored attribute must be
    paired, in the same function, with the corresponding column write or
    a sync call (``_sync_plane`` / ``plane.alloc`` / ``plane.free``).
    MIR103: every queue payload write (``req_objs[i] = req``) must be
    paired, in the same function, with writes to every key column in
    :data:`repro_torch.serving.global_queue.QUEUE_KEY_COLUMNS` (``None``
    assignments clear a freed cell and are exempt — the key cells behind
    the cursor are dead).
    MIR104: every *terminal* state write must pair with a ``state``
    column write naming the same terminal code (see
    :data:`_TERMINAL_NAMES`)."""
    for fn in _functions(tree):
        if fn.name in _INIT_FUNCS:
            continue
        obj_writes: List[Tuple[str, str, str, int]] = []
        payload_writes: List[int] = []
        term_writes: List[Tuple[str, int]] = []
        term_cols: set = set()
        mirror_cols = set()
        plane_synced = False

        def container_write(attr: str, lineno: int) -> None:
            obj_writes.append((attr, PLANE_CONTAINER_MIRRORS[attr],
                               "MIR102", lineno))

        for node in _own_nodes(fn):
            for tgt in _flat_targets(node):
                if isinstance(tgt, ast.Attribute):
                    a = tgt.attr
                    if a in LEDGER_MIRRORS:
                        # `state` is also an instance/engine attribute;
                        # only RequestState writes are the Request mirror
                        if a == "state" and not _mentions(node,
                                                          "RequestState"):
                            continue
                        obj_writes.append((a, LEDGER_MIRRORS[a], "MIR101",
                                           tgt.lineno))
                        if a == "state":
                            for term in _TERMINAL_NAMES:
                                if _mentions(node, term):
                                    term_writes.append((term, tgt.lineno))
                    elif a in PLANE_MIRRORS:
                        obj_writes.append((a, PLANE_MIRRORS[a], "MIR102",
                                           tgt.lineno))
                elif isinstance(tgt, ast.Subscript) \
                        and isinstance(tgt.value, ast.Attribute):
                    base = tgt.value.attr
                    if base in PLANE_CONTAINER_MIRRORS:
                        container_write(base, tgt.lineno)
                    else:
                        mirror_cols.add(base)
                        if base == "state":
                            for term in _TERMINAL_NAMES:
                                if _mentions(node, term):
                                    term_cols.add(term)
                        if base == _QUEUE_PAYLOAD \
                                and not (isinstance(node, ast.Assign)
                                         and isinstance(node.value,
                                                        ast.Constant)
                                         and node.value.value is None):
                            payload_writes.append(tgt.lineno)
            if isinstance(node, ast.Delete):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript) \
                            and isinstance(tgt.value, ast.Attribute) \
                            and tgt.value.attr in PLANE_CONTAINER_MIRRORS:
                        container_write(tgt.value.attr, tgt.lineno)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                f = node.func
                if f.attr == "_sync_plane":
                    plane_synced = True
                elif f.attr in ("alloc", "free"):
                    recv = f.value
                    if (isinstance(recv, ast.Attribute)
                            and recv.attr == "plane") \
                            or (isinstance(recv, ast.Name)
                                and recv.id in ("plane", "pl")):
                        plane_synced = True
                elif f.attr == "clear" \
                        and isinstance(f.value, ast.Attribute) \
                        and f.value.attr in PLANE_CONTAINER_MIRRORS:
                    container_write(f.value.attr, node.lineno)

        missing = [c for c in QUEUE_KEY_COLUMNS if c not in mirror_cols]
        if missing:
            for lineno in payload_writes:
                out.emit("MIR103", lineno,
                         "queue payload write without the paired key-"
                         f"column write(s) {', '.join(missing)} in "
                         f"`{fn.name}` (suppress with "
                         "`# mirror-sync: ok(<reason>)` if the columns "
                         "are settled elsewhere)", fn_line=fn.lineno)

        for term, lineno in term_writes:
            if term not in term_cols:
                out.emit("MIR104", lineno,
                         f"terminal state write `RequestState.{term}` "
                         "without a `state` column write naming "
                         f"`{term}` in `{fn.name}` — route terminal "
                         "transitions through the RequestLedger "
                         "`mark_*` helpers (suppress with "
                         "`# mirror-sync: ok(<reason>)` if the column "
                         "is settled elsewhere)", fn_line=fn.lineno)

        for attr, col, rule, lineno in obj_writes:
            if col in mirror_cols:
                continue
            if rule == "MIR102" and plane_synced:
                continue
            kind = "ledger column" if rule == "MIR101" else "plane column"
            out.emit(rule, lineno,
                     f"write to mirrored attribute `{attr}` without the "
                     f"paired {kind} `{col}` write"
                     + ("" if rule == "MIR101"
                        else " or a _sync_plane()/plane.alloc/free call")
                     + f" in `{fn.name}` (suppress with "
                     "`# mirror-sync: ok(<reason>)` if the mirror is "
                     "settled by the caller)", fn_line=fn.lineno)


# ---------------------------------------------------- determinism rules
def _check_rng(tree: ast.Module, out: _Collector) -> None:
    """DET201: unseeded global RNG calls."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if len(chain) == 2 and chain[0] == "random" \
                and chain[1] not in _SEEDED_STDLIB:
            out.emit("DET201", node.lineno,
                     f"unseeded global RNG `random.{chain[1]}()` — use a "
                     "seeded `random.Random(seed)` (or numpy "
                     "`default_rng`) instead")
        elif len(chain) == 3 and chain[0] in ("np", "numpy") \
                and chain[1] == "random" and chain[2] not in _SEEDED_NP:
            out.emit("DET201", node.lineno,
                     f"unseeded global RNG `{chain[0]}.random."
                     f"{chain[2]}()` — draw from a "
                     "`np.random.default_rng(seed)` Generator instead")


def _check_wall_clock(tree: ast.Module, out: _Collector) -> None:
    """DET202: wall-clock reads outside benchmarks//scripts/."""
    if _wall_clock_exempt(out.path):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if not chain:
            continue
        bad = (len(chain) == 2 and chain[0] == "time"
               and chain[1] in _WALL_CLOCK_TIME) \
            or (chain[-1] in ("now", "today", "utcnow")
                and any(p in ("datetime", "date") for p in chain[:-1]))
        if bad:
            out.emit("DET202", node.lineno,
                     f"wall-clock read `{'.'.join(chain)}()` in simulation"
                     "/control code — thread sim time through instead "
                     "(wall clocks are only for benchmarks/ and scripts/)")


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Set) or isinstance(node, ast.SetComp):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.BinOp) \
            and isinstance(node.op, (ast.BitOr, ast.BitAnd, ast.BitXor,
                                     ast.Sub)):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


def _check_set_iteration(tree: ast.Module, out: _Collector) -> None:
    """DET203: iterating a set expression — address-dependent order."""
    iters: List[Tuple[ast.AST, int]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.For):
            iters.append((node.iter, node.iter.lineno))
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                iters.append((gen.iter, gen.iter.lineno))
    for expr, lineno in iters:
        if _is_set_expr(expr):
            out.emit("DET203", lineno,
                     "iteration over a set expression feeds an "
                     "address-dependent order into the run — wrap it in "
                     "sorted(...) to fix the order")


def _tuple_has_tiebreaker(key: ast.Tuple) -> bool:
    for elt in key.elts[1:]:
        if isinstance(elt, ast.Call) and isinstance(elt.func, ast.Name) \
                and elt.func.id == "next":
            return True
        name = None
        if isinstance(elt, ast.Name):
            name = elt.id
        elif isinstance(elt, ast.Attribute):
            name = elt.attr
        if name is not None and any(f in name.lower()
                                    for f in _TIEBREAK_FRAGMENTS):
            return True
    return False


def _check_heap_keys(tree: ast.Module, out: _Collector) -> None:
    """DET204: heappush keys must be total-order tuples with an explicit
    tiebreaker after the time (`(deadline, arrival, seq)` idiom) — raw
    objects in a heap compare by address or raise on ties."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if not chain or chain[-1] != "heappush" or len(node.args) < 2:
            continue
        key = node.args[1]
        if not isinstance(key, ast.Tuple):
            out.emit("DET204", node.lineno,
                     "heappush key is not an inline tuple — push "
                     "`(time, ..., seq)` total-order tuples so ties "
                     "never compare payload objects")
        elif len(key.elts) < 2 or not _tuple_has_tiebreaker(key):
            out.emit("DET204", node.lineno,
                     "heappush tuple has no total-order tiebreaker "
                     "(a seq/id/epoch field or next(counter)) after "
                     "the primary time key")


def _check_event_time_compare(tree: ast.Module, out: _Collector) -> None:
    """DET205: raw comparisons between a scheduled event time and the
    current time lose events to accumulated float drift (a READY
    event lost at the boundary) — compare against `t + eps` or clamp like
    `activate_if_ready(max(t, ready_time))`."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        operands = [node.left] + list(node.comparators)
        for i, op in enumerate(node.ops):
            if not isinstance(op, _CMP_OPS):
                continue
            left, right = operands[i], operands[i + 1]
            for a, b in ((left, right), (right, left)):
                if isinstance(a, ast.Attribute) \
                        and a.attr in _EVENT_TIME_ATTRS \
                        and isinstance(b, ast.Name) \
                        and b.id in _CURRENT_TIME_NAMES:
                    out.emit("DET205", node.lineno,
                             f"raw comparison of scheduled `{a.attr}` "
                             f"against `{b.id}` — accumulated float "
                             "drift loses events at the boundary; "
                             "compare with an epsilon term or clamp "
                             "(`max(t, ready_time)`)")
                    break


# -------------------------------------------------------- hygiene rules
def _check_unused_imports(tree: ast.Module, source: str,
                          out: _Collector) -> None:
    """LINT301: module-level imports never referenced again."""
    if os.path.basename(out.path) == "__init__.py":
        return                       # re-export surface by convention
    binds: List[Tuple[str, int]] = []
    import_extents: List[Tuple[int, int]] = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            import_extents.append((node.lineno, node.end_lineno))
            for alias in node.names:
                binds.append((alias.asname or alias.name.split(".")[0],
                              node.lineno))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            import_extents.append((node.lineno, node.end_lineno))
            for alias in node.names:
                if alias.name == "*":
                    continue
                binds.append((alias.asname or alias.name, node.lineno))
    if not binds:
        return
    lines = source.splitlines()
    skip = set()
    for lo, hi in import_extents:
        skip.update(range(lo, (hi or lo) + 1))
    body = "\n".join(ln for i, ln in enumerate(lines, start=1)
                     if i not in skip)
    for name, lineno in binds:
        # word-boundary text search (not just Name nodes) so imports
        # used only inside quoted annotations don't false-positive
        if not re.search(rf"(?<![\w.]){re.escape(name)}\b", body):
            out.emit("LINT301", lineno,
                     f"`{name}` is imported but never used")


def _check_mutable_defaults(tree: ast.Module, out: _Collector) -> None:
    """LINT302: mutable default arguments are shared across calls."""
    for fn in _functions(tree):
        defaults = list(fn.args.defaults) + [d for d in fn.args.kw_defaults
                                             if d is not None]
        for d in defaults:
            mutable = isinstance(d, (ast.List, ast.Dict, ast.Set)) \
                or (isinstance(d, ast.Call)
                    and isinstance(d.func, ast.Name)
                    and d.func.id in ("list", "dict", "set"))
            if mutable:
                out.emit("LINT302", d.lineno,
                         f"mutable default argument in `{fn.name}` — "
                         "default to None and build inside the function")


def analyze_code(code: str, *, path: str = "<string>",
                 rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run every rule over one module's source; returns findings sorted
    by line. ``rules`` narrows to the given rule ids (prefix match, so
    ``["MIR"]`` selects both mirror rules)."""
    tree = ast.parse(code, filename=path)
    out = _Collector(path, Suppressions(code), rules)
    if _mirror_rules_apply(path):
        _check_mirrors(tree, out)
    _check_rng(tree, out)
    _check_wall_clock(tree, out)
    _check_set_iteration(tree, out)
    _check_heap_keys(tree, out)
    _check_event_time_compare(tree, out)
    _check_unused_imports(tree, code, out)
    _check_mutable_defaults(tree, out)
    out.findings.sort(key=lambda f: (f.line, f.rule))
    return out.findings
