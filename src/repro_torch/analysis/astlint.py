"""Repo-specific AST lint (analysis plane 2). stdlib ``ast`` only.

Six rules, each encoding a serving-stack discipline that an ordinary
linter cannot know about:

  no-raw-clock              a ``serving/`` module that declares an
                            injectable ``clock`` parameter must not call
                            ``time.time()``/``time.monotonic()`` — raw
                            clock reads bypass the injection point that
                            makes deadline tests deterministic.
  pump-single-owner         ``service.py`` HTTP handler scope (``async
                            def``) must not CALL methods through
                            ``self.service...``/``...engine...`` — the
                            pump thread is the single owner of engine and
                            service state; handlers talk to it via the
                            inbox (``self._ask``/``self._inbox.append``).
                            Attribute READS stay allowed.
  no-host-sync-in-hot-path  a dispatch body (the callable handed to
                            ``GraphCache.run`` / ``graphs.run`` as
                            ``body``, a lambda or a nested ``def``, and
                            the body of a ``with torch.cuda.graph(...)``
                            block) must not call ``np.asarray``/
                            ``int()``/``float()``/``.item()``: each is a
                            device sync, which breaks the one host sync a
                            dispatch may cost and a CUDA graph's capture.
  bench-gate-message        ``check_bench.py`` gates must not use bare
                            ``assert`` without a measured-vs-threshold
                            message (a bare assert fails CI with no
                            number to debug from). The port has no gate
                            script yet (the benchmark brings one), so the
                            rule has no target until then.
  duplicate-hot-path-helper the host-side greedy-argmax fallback
                            ``int(np.argmax(np.asarray(...)))`` may
                            appear in at most one function per module —
                            the copy-paste that let two emission paths
                            drift apart.
  stats-schema              any ``stats["key"]`` written in ``serving/``
                            (subscript assignment or a ``self.stats =
                            {...}`` dict literal) must be declared in
                            ``repro_torch.telemetry.schema``: ``GET /metrics``
                            renders every stats key, so an undeclared key
                            would silently fall off the exposition (the
                            registry raises at Service construction, but
                            only on the code path that runs; the lint
                            catches every write site statically).

The files linted (``default_targets``) are the port's ``serving/*.py`` and
its CI scripts (``repro_torch/scripts/*.py``); ``rules_for`` picks each
file's rules by its path, and no rule scopes the scripts today.

Escape hatch: append ``# repro-lint: disable=<rule>[,<rule>...]`` (or
``disable=all``) to the flagged line. Every disable is deliberate and
greppable. (The watchdog heartbeat's wall-clock reads no longer need
one: they go through ``repro_torch.telemetry.clock.wall_clock``, the single
sanctioned raw-clock helper, instead of per-site escapes.)
"""
from __future__ import annotations

import ast
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.report import Violation
from repro_torch.telemetry.schema import DECLARED_STAT_KEYS

RULES = ("no-raw-clock", "pump-single-owner", "no-host-sync-in-hot-path",
         "bench-gate-message", "duplicate-hot-path-helper", "stats-schema")

_DISABLE_RE = re.compile(r"#\s*repro-lint:\s*disable=([\w\-,\s]+)")

# pump-single-owner: attribute segments that mark pump-owned state, and
# self-rooted call chains handlers may use (the inbox protocol)
_OWNED_SEGMENTS = ("service", "engine")
_INBOX_WHITELIST = (("self", "_ask"), ("self", "_inbox", "append"))

_RAW_CLOCK_CALLS = (("time", "time"), ("time", "monotonic"))


def _disabled_rules(source: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for lineno, line in enumerate(source.splitlines(), 1):
        m = _DISABLE_RE.search(line)
        if m:
            out[lineno] = {r.strip() for r in m.group(1).split(",")
                           if r.strip()}
    return out


def _attr_chain(node: ast.AST) -> Tuple[str, ...]:
    """x.a.b.c -> ("x", "a", "b", "c"); non-name roots yield ("?", ...)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    parts.append(node.id if isinstance(node, ast.Name) else "?")
    return tuple(reversed(parts))


def _functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _declares_clock_param(tree: ast.AST) -> bool:
    for fn in _functions(tree):
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            if a.arg == "clock":
                return True
    return False


# ----------------------------------------------------------------- rules
def _rule_no_raw_clock(tree: ast.AST) -> List[Tuple[int, str]]:
    if not _declares_clock_param(tree):
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and _attr_chain(node.func) in _RAW_CLOCK_CALLS:
            out.append((node.lineno,
                        f"raw {'.'.join(_attr_chain(node.func))}() in a "
                        f"module that declares an injectable clock — "
                        f"thread the clock parameter through instead"))
    return out


def _rule_pump_single_owner(tree: ast.AST) -> List[Tuple[int, str]]:
    out = []
    for fn in _functions(tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain in _INBOX_WHITELIST:
                continue
            if chain[0] == "self" and any(s in chain[1:-1]
                                          for s in _OWNED_SEGMENTS):
                out.append((
                    node.lineno,
                    f"handler scope calls {'.'.join(chain)}() — engine/"
                    f"service state is pump-owned; post to the inbox "
                    f"(self._ask / self._inbox.append) instead"))
    return out


def _is_graph_run(node: ast.AST) -> bool:
    """``<...>.graphs.run(...)`` or ``GraphCache.run(...)``."""
    if not isinstance(node, ast.Call):
        return False
    chain = _attr_chain(node.func)
    return (len(chain) >= 2 and chain[-1] == "run"
            and chain[-2] in ("graphs", "GraphCache"))


def _is_graph_capture(item: ast.withitem) -> bool:
    """``with torch.cuda.graph(...)``."""
    expr = item.context_expr
    return (isinstance(expr, ast.Call)
            and _attr_chain(expr.func)[-2:] == ("cuda", "graph"))


def _hot_bodies(tree: ast.AST) -> List[Tuple[str, List[ast.AST]]]:
    """(name, nodes) of every dispatch body: the ``body`` handed to a
    graph cache's ``run`` (a lambda, or the name of a function defined in
    the module) and the statements of a ``torch.cuda.graph`` block."""
    defs: Dict[str, List[ast.AST]] = {}
    for fn in _functions(tree):
        defs.setdefault(fn.name, []).append(fn)
    out: List[Tuple[str, List[ast.AST]]] = []
    for node in ast.walk(tree):
        if _is_graph_run(node):
            body = (node.args[2] if len(node.args) > 2 else
                    next((k.value for k in node.keywords
                          if k.arg == "body"), None))
            if isinstance(body, ast.Lambda):
                out.append(("<lambda>", [body.body]))
            elif isinstance(body, ast.Name) and body.id in defs:
                out.append((body.id, defs[body.id]))
        elif isinstance(node, (ast.With, ast.AsyncWith)) \
                and any(_is_graph_capture(i) for i in node.items):
            out.append(("torch.cuda.graph", list(node.body)))
    return out


def _rule_no_host_sync(tree: ast.AST) -> List[Tuple[int, str]]:
    out = []
    seen: Set[int] = set()
    for name, nodes in _hot_bodies(tree):
        for root in nodes:
            for node in ast.walk(root):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                chain = _attr_chain(node.func)
                sync = None
                if chain in (("np", "asarray"), ("numpy", "asarray")):
                    sync = "np.asarray"
                elif chain in (("int",), ("float",)):
                    sync = f"{chain[0]}()"
                elif chain[-1] == "item" and len(chain) > 1:
                    sync = ".item()"
                if sync:
                    seen.add(id(node))
                    out.append((
                        node.lineno,
                        f"{sync} inside dispatch body {name!r} forces a "
                        f"device sync — keep host conversions outside the "
                        f"captured dispatch"))
    return out


def _rule_bench_gate_message(tree: ast.AST) -> List[Tuple[int, str]]:
    return [
        (node.lineno,
         "bare assert in a bench gate — include the measured value and "
         "threshold in the message (or raise via fail())")
        for node in ast.walk(tree)
        if isinstance(node, ast.Assert) and node.msg is None]


def _is_argmax_fallback(node: ast.AST) -> bool:
    """int(np.argmax(np.asarray(...)))"""
    if not (isinstance(node, ast.Call) and _attr_chain(node.func) == ("int",)
            and node.args):
        return False
    inner = node.args[0]
    if not (isinstance(inner, ast.Call)
            and _attr_chain(inner.func)[-1] == "argmax" and inner.args):
        return False
    arg = inner.args[0]
    return (isinstance(arg, ast.Call)
            and _attr_chain(arg.func)[-1] == "asarray")


def _rule_duplicate_helper(tree: ast.AST) -> List[Tuple[int, str]]:
    sites: List[Tuple[str, int]] = []
    for fn in _functions(tree):
        for node in ast.walk(fn):
            if _is_argmax_fallback(node):
                sites.append((fn.name, node.lineno))
                break           # one hit per function is enough
    if len({name for name, _ in sites}) <= 1:
        return []
    return [
        (line,
         f"greedy-argmax fallback duplicated in {fn!r} — "
         f"{len(sites)} functions in this module carry the same "
         f"int(np.argmax(np.asarray(...))) pattern; share one helper")
        for fn, line in sites]


def _rule_stats_schema(tree: ast.AST) -> List[Tuple[int, str]]:
    declared = DECLARED_STAT_KEYS
    out = []

    def flag(lineno: int, key: str) -> None:
        out.append((
            lineno,
            f"stats key {key!r} is not declared in "
            f"repro_torch.telemetry.schema "
            f"— GET /metrics renders every stats key, so declare it "
            f"(kind + help) in ENGINE_STATS/SERVICE_STATS or it falls off "
            f"the exposition"))

    for node in ast.walk(tree):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AugAssign)
                   else [])
        for t in targets:
            # stats["key"] = / += writes with a literal key
            if (isinstance(t, ast.Subscript)
                    and _attr_chain(t.value)[-1] == "stats"
                    and isinstance(t.slice, ast.Constant)
                    and isinstance(t.slice.value, str)
                    and t.slice.value not in declared):
                flag(t.lineno, t.slice.value)
            # self.stats = {...} dict-literal initializers
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Dict)
                    and isinstance(t, (ast.Attribute, ast.Name))
                    and _attr_chain(t)[-1] == "stats"):
                for k in node.value.keys:
                    if (isinstance(k, ast.Constant)
                            and isinstance(k.value, str)
                            and k.value not in declared):
                        flag(k.lineno, k.value)
    return out


# ---------------------------------------------------------- entry points
def rules_for(filename: str) -> Tuple[str, ...]:
    """Which rules apply to a file, by its repo-relative path."""
    p = pathlib.PurePosixPath(str(filename).replace("\\", "/"))
    out: List[str] = []
    if "serving" in p.parts:
        out += ["no-raw-clock", "no-host-sync-in-hot-path",
                "duplicate-hot-path-helper", "stats-schema"]
        if p.name == "service.py":
            out.append("pump-single-owner")
    if p.name == "check_bench.py":
        out.append("bench-gate-message")
    return tuple(out)


_RULE_FNS = {
    "no-raw-clock": _rule_no_raw_clock,
    "pump-single-owner": _rule_pump_single_owner,
    "no-host-sync-in-hot-path": _rule_no_host_sync,
    "bench-gate-message": _rule_bench_gate_message,
    "duplicate-hot-path-helper": _rule_duplicate_helper,
    "stats-schema": _rule_stats_schema,
}


def lint_source(source: str, filename: str,
                rules: Optional[Iterable[str]] = None) -> List[Violation]:
    """Lint one module's source. ``rules=None`` selects by filename
    (``rules_for``); tests pass explicit rules against fixture snippets."""
    selected = tuple(rules) if rules is not None else rules_for(filename)
    if not selected:
        return []
    tree = ast.parse(source, filename=str(filename))
    disabled = _disabled_rules(source)
    out: List[Violation] = []
    for rule in selected:
        for lineno, msg in _RULE_FNS[rule](tree):
            d = disabled.get(lineno, ())
            if rule in d or "all" in d:
                continue
            out.append(Violation("ast", rule, str(filename), msg,
                                 line=lineno))
    return sorted(out, key=lambda v: (v.where, v.line or 0, v.rule))


def default_targets(root) -> List[pathlib.Path]:
    """The port's serving modules and its CI scripts."""
    root = pathlib.Path(root)
    pkg = root / "src" / "repro_torch"
    return (sorted((pkg / "serving").glob("*.py"))
            + sorted((pkg / "scripts").glob("*.py")))


def lint_tree(root) -> List[Violation]:
    root = pathlib.Path(root)
    out: List[Violation] = []
    for path in default_targets(root):
        rel = path.relative_to(root).as_posix()
        out += lint_source(path.read_text(), rel)
    return out
