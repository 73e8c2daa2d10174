"""Violation records shared by both analysis planes.

One shape for everything ``scripts/check_static.py`` prints and gates on:
the dispatch plane reports against a (hot-path name, scenario) coordinate,
the AST plane against a (file, line) coordinate. Both collapse to the same
record, so the gate needs exactly one "any violations -> exit 1" loop.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class Violation:
    plane: str              # "dispatch" | "ast"
    rule: str               # e.g. "f32-roundtrip", "no-raw-clock"
    where: str              # "engine.decode[int8+paged]" or "path/file.py"
    message: str
    line: Optional[int] = None

    def __str__(self) -> str:
        loc = f"{self.where}:{self.line}" if self.line else self.where
        return f"[{self.plane}:{self.rule}] {loc}: {self.message}"


def render(violations: List[Violation]) -> str:
    if not violations:
        return "static checks: OK (0 violations)"
    lines = [str(v) for v in violations]
    lines.append(f"static checks: {len(violations)} violation(s)")
    return "\n".join(lines)
