"""Finding model + suppression-comment index for the static auditor."""
from __future__ import annotations

import re
from dataclasses import asdict, dataclass
from typing import Dict, Optional, Set

# `# mirror-sync: ok(<reason>)` — suppress MIR rules on a line / function
_MIRROR_OK = re.compile(r"#\s*mirror-sync:\s*ok\(([^)]*)\)")
# `# mirror-sync: module ok(<reason>)` — exempt the whole module from MIR
_MIRROR_MODULE_OK = re.compile(r"#\s*mirror-sync:\s*module\s+ok\(([^)]*)\)")
# `# repro-lint: ok(RULE_ID, <reason>)` — suppress one rule on a line
_LINT_OK = re.compile(r"#\s*repro-lint:\s*ok\(\s*([A-Z]+\d+)\s*(?:,([^)]*))?\)")

_MIR_ALL = "MIR*"


@dataclass(frozen=True)
class Finding:
    """One rule violation: where, which rule, and what to do about it."""
    rule: str
    path: str
    line: int
    message: str

    def to_dict(self) -> Dict[str, object]:
        return asdict(self)

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


class Suppressions:
    """Per-line suppression index parsed from the raw source text.

    ``suppressed(rule, line)`` answers for single-line suppressions; the
    analyzer additionally consults the ``def`` line of the enclosing
    function so a suppression there covers the whole body. A suppression
    on a comment-only line also covers the next line, so long statements
    can carry one without blowing the line width.
    """

    def __init__(self, source: str):
        self.module_mirror_exempt = False
        self._by_line: Dict[int, Set[str]] = {}

        def add(lineno: int, rule: str, standalone: bool) -> None:
            self._by_line.setdefault(lineno, set()).add(rule)
            if standalone:
                self._by_line.setdefault(lineno + 1, set()).add(rule)

        for lineno, text in enumerate(source.splitlines(), start=1):
            if "#" not in text:
                continue
            standalone = text.lstrip().startswith("#")
            if _MIRROR_MODULE_OK.search(text):
                self.module_mirror_exempt = True
                continue
            if _MIRROR_OK.search(text):
                add(lineno, _MIR_ALL, standalone)
            m = _LINT_OK.search(text)
            if m:
                add(lineno, m.group(1), standalone)

    def suppressed(self, rule: str, line: Optional[int]) -> bool:
        if rule.startswith("MIR") and self.module_mirror_exempt:
            return True
        if line is None:
            return False
        rules = self._by_line.get(line)
        if not rules:
            return False
        if rule in rules:
            return True
        return rule.startswith("MIR") and _MIR_ALL in rules
