"""AST lint of the port's sources.

Port of `eventgrad_tpu/analysis/lint.py`: the framework (`Violation`,
`SourceFile`, `collect_sources`, `Rule`, `RULES`, `run`, `main`) and the
rules that apply to what the port has. Each rule walks parsed ASTs, so
docstrings and comments never match.

  * no-host-sync-in-traced — `.item()`, `.cpu()`, `.tolist()`,
    `.numpy()` and `torch.cuda.synchronize` in the port's `parallel/`,
    `ops/` or `train/steps.py`: a host round trip on the step's path
    (the torch spelling of the JAX rule's `block_until_ready` and
    `device_get`). The auditor sees the same syncs in the traced graph.
  * kernel-registered — every `eg::` operator defined in the package
    (`torch.library.custom_op("eg::<name>")`) and every kernel launch
    through the library (`lib.eg_<entry>`) names an entry of
    `analysis/kernels.py` declared for that module; every entry still
    names a live op and launch in its module (stale entries flag). The
    one named exemption is the auditor's seeded unregistered kernel in
    `analysis/audit.py`, honesty-checked: it must still define an
    unregistered op and launch, and must stay out of the registry. The
    host data library's entries (`data/native.py`, `HOST_LIBRARIES`)
    are no kernels and pass, but a registered kernel's entry there
    flags, and the file must still call its library.
  * trigger-policy-registered — every trigger-policy name given as a
    string (`trigger_policy=`, `AuditConfig(policy=...)`, the CLI's
    `--trigger-policy` choices) is an entry of `parallel/policy.py`
    `POLICIES`, and every entry is among the CLI's choices.
  * carrier-dtype-declared — the receive buffers' resident dtype is
    declared once, by `parallel/arena.py` `alloc_event_bufs`: an ad-hoc
    `.to(...)` inside a `bufs=` / `buf_scales=` keyword flags, and the
    EventState owner must still allocate through the helper.
  * exit-code-literals — the exit codes are a contract: outside
    `exitcodes.py` the package spells them `exitcodes.<NAME>`, never by
    value.
  * os-exit-confined — `os._exit` belongs to `chaos/crashpoint.py`.
  * crashpoint-instrumented — every registered crash site is
    instrumented at exactly one literal `crashpoint.hit("<name>")` call,
    and no unregistered name is; a site whose seam the port does not
    have yet is declared in `WAITING` with its ROADMAP item, and must
    stay uninstrumented while it waits.
  * wall-clock-confined — wall-clock reads (`time.time`,
    `perf_counter`, `monotonic` and their `_ns` forms, through any alias)
    belong to `obs/` (Registry spans); every other file that reads the
    clock has a named `EXEMPT` entry with its reason, honesty-checked
    (an exempt file that no longer reads the clock flags).
  * telemetry-counter-ledgered — the message ledger's counters
    (`counts`, `queue`, `late_queue`) move only inside
    `obs/ledger.py` `ledger_update`: an in-place add on them
    (`index_add_`, `scatter_add_`, `add_`, `index_put_`, `+=`, `[...]
    +=`) anywhere else flags, as does a `ledger=` keyword computed at the
    call site; and `ledger_update` must still add to the counters
    itself, or the rule covers nothing.

The port's counterparts of the JAX lint's three shard_map rules read
the port's test files (`tests/test_torch_*.py`), where the device-mesh
lift is exercised in `torch.distributed` groups:

  * process-group-marker — a test file that starts a process group
    (imports `_torch_dist`, the one helper that starts them, or calls
    `init_process_group`) imports the helper's `requires_gloo` skip
    marker;
  * process-group-respell — no test file re-spells that skip (a
    `skipif` whose condition mentions gloo): `tests/_torch_dist.py`
    holds the one definition and its one reason string;
  * process-group-exempt-honest — every file of `DIST_EXEMPT` still
    exists and still starts a group (the list is empty).

CLI: `python -m eventgrad_tpu_torch.analysis.lint`.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import sys
from functools import cached_property
from typing import Dict, Iterable, List, Optional, Sequence, Set

from eventgrad_tpu_torch import exitcodes

PACKAGE = "eventgrad_tpu_torch"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str  #: repo-relative, with forward slashes
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class SourceFile:
    path: str
    rel: str  #: repo-relative, with forward slashes
    text: str

    @cached_property
    def tree(self) -> ast.AST:
        return ast.parse(self.text, filename=self.rel)


def collect_sources(root: str = REPO_ROOT,
                    subdirs: Sequence[str] = (PACKAGE,)) -> List[SourceFile]:
    out = []
    for sub in subdirs:
        base = os.path.join(root, sub)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                with open(path, encoding="utf-8") as fh:
                    out.append(SourceFile(
                        path=path,
                        rel=os.path.relpath(path, root).replace(os.sep, "/"),
                        text=fh.read(),
                    ))
    return out


class Rule:
    name: str = "rule"
    #: the files `run` gives the rule: the package's, or the port's tests
    scope: str = "package"

    def check(self, files: Sequence[SourceFile]) -> List[Violation]:
        raise NotImplementedError

    def _v(self, sf: SourceFile, line: int, message: str) -> Violation:
        return Violation(self.name, sf.rel, line, message)


def _in_package(sf: SourceFile) -> bool:
    return sf.rel.startswith(PACKAGE + "/")


def _call_name(node: ast.Call) -> Optional[str]:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class NoHostSyncInTraced(Rule):
    """No host round trips on the step's paths."""

    name = "no-host-sync-in-traced"
    SCOPES = (f"{PACKAGE}/parallel/", f"{PACKAGE}/ops/",
              f"{PACKAGE}/train/steps.py")
    BANNED_ATTRS = ("item", "cpu", "tolist", "numpy")

    def check(self, files):
        out = []
        for sf in files:
            if not any(sf.rel.startswith(s) for s in self.SCOPES):
                continue
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Attribute):
                    continue
                what = None
                if node.attr in self.BANNED_ATTRS:
                    what = f".{node.attr}()"
                elif (node.attr == "synchronize"
                      and isinstance(node.value, ast.Attribute)
                      and node.value.attr == "cuda"):
                    what = "torch.cuda.synchronize"
                if what is not None:
                    out.append(self._v(
                        sf, node.lineno,
                        f"{what} on a traced path — a host sync the step "
                        "cannot hide; read back at the loop boundary "
                        "instead",
                    ))
        return out


class KernelRegistered(Rule):
    """Every kernel op and launch names a registered kernel
    (`analysis/kernels.py`) of its module; every entry still has both.
    The trace auditor refuses an unregistered op when a cell reaches
    it; this rule catches the drift in the source."""

    name = "kernel-registered"
    #: the one named exemption: the auditor's seeded unregistered kernel
    #: (the violation that proves the registry check fires)
    EXEMPT = {
        f"{PACKAGE}/analysis/audit.py":
            "oracle_unregistered_kernel's seeded eg::leak_kernel "
            "(csrc/audit_leak.cu, launched as eg_leak_x2)",
    }
    #: the files that call a host library's `eg_` entries, which are not
    #: kernels (no op, no device work): their entries are exempt, but a
    #: registered kernel's entry there still flags, and a listed file
    #: that no longer calls its library flags (the entry has gone stale)
    HOST_LIBRARIES = {
        f"{PACKAGE}/data/native.py":
            "the host data library (native/dataio.cpp: the MNIST/CIFAR "
            "readers, JPEG codec, shard plan and batch gathers)",
    }

    @staticmethod
    def _op_defs(sf):
        """(line, name) of every `custom_op("eg::<name>", ...)`."""
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) and _call_name(node) == "custom_op" \
                    and node.args:
                s = _const_str(node.args[0])
                if s is not None and s.startswith("eg::"):
                    yield node.lineno, s[len("eg::"):]

    @staticmethod
    def _launches(sf):
        """(line, entry) of every `<library>.eg_<entry>` attribute."""
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Attribute) and node.attr.startswith("eg_"):
                yield node.lineno, node.attr

    def check(self, files):
        from eventgrad_tpu_torch.analysis import kernels

        out = []
        ops_seen: Dict[str, Set[str]] = {}
        entries_seen: Dict[str, Set[str]] = {}
        by_entry = {sig.entry: sig for sig in kernels.REGISTRY.values()}
        for sf in files:
            if not _in_package(sf):
                continue
            own: List[Violation] = []
            for line, name in self._op_defs(sf):
                sig = kernels.REGISTRY.get(name)
                if sig is None:
                    own.append(self._v(
                        sf, line,
                        f"kernel op 'eg::{name}' has no declared rank "
                        "layout — register it in analysis/kernels.py (the "
                        "trace auditor refuses unregistered kernels; "
                        "ROADMAP 'Registering a kernel')"))
                elif sig.module != sf.rel:
                    own.append(self._v(
                        sf, line,
                        f"kernel op 'eg::{name}' is registered for "
                        f"{sig.module}, defined in {sf.rel}"))
                else:
                    ops_seen.setdefault(sf.rel, set()).add(name)
            host = sf.rel in self.HOST_LIBRARIES
            if host and not any(e not in by_entry
                                for _, e in self._launches(sf)):
                own.append(self._v(
                    sf, 1,
                    "host-library file no longer calls its library's eg_ "
                    "entries — drop it from KernelRegistered.HOST_LIBRARIES"
                    f" ({self.HOST_LIBRARIES[sf.rel]})"))
            for line, entry in self._launches(sf):
                sig = by_entry.get(entry)
                if sig is None and host:
                    continue
                if sig is None:
                    own.append(self._v(
                        sf, line,
                        f"kernel launch '{entry}' names no registered "
                        "kernel — register its op in analysis/kernels.py"))
                elif sig.module != sf.rel:
                    own.append(self._v(
                        sf, line,
                        f"kernel launch '{entry}' is registered for "
                        f"{sig.module}, launched from {sf.rel}"))
                else:
                    entries_seen.setdefault(sf.rel, set()).add(entry)
            if sf.rel in self.EXEMPT:
                defined = {n for _, n in self._op_defs(sf)}
                registered = sorted(defined & set(kernels.REGISTRY))
                if registered:
                    out.append(self._v(
                        sf, 1,
                        f"the exempt fixture's op {registered} is "
                        "registered — the unregistered-kernel oracle would "
                        "pass it; drop it from analysis/kernels.py"))
                unreg_ops = defined - set(kernels.REGISTRY)
                unreg_launches = {e for _, e in self._launches(sf)
                                  if e not in by_entry}
                if not (unreg_ops and unreg_launches):
                    out.append(self._v(
                        sf, 1,
                        "exempt file no longer defines and launches an "
                        "unregistered kernel — drop it from "
                        f"KernelRegistered.EXEMPT ({self.EXEMPT[sf.rel]})"))
                continue
            out.extend(own)
        scanned = {sf.rel for sf in files}
        for name, sig in sorted(kernels.REGISTRY.items()):
            if sig.module not in scanned:
                continue
            if name not in ops_seen.get(sig.module, set()):
                out.append(Violation(
                    self.name, sig.module, 1,
                    f"registered kernel 'eg::{name}' is not defined in "
                    f"{sig.module} — the registry entry has gone stale"))
            if sig.entry not in entries_seen.get(sig.module, set()):
                out.append(Violation(
                    self.name, sig.module, 1,
                    f"registered kernel 'eg::{name}' never launches "
                    f"'{sig.entry}' in {sig.module} — the registry entry "
                    "has gone stale"))
        return out


class TriggerPolicyRegistered(Rule):
    """Every trigger-policy name given as a string (`trigger_policy=`,
    `AuditConfig(policy=...)`, the CLI's `--trigger-policy` choices)
    resolves to a `parallel/policy.py` `POLICIES` entry (a typo fails
    only at run time, deep inside a training run); and, the stale
    direction, every registry entry is among the CLI's choices (a policy
    the flag cannot name is dead surface)."""

    name = "trigger-policy-registered"

    @staticmethod
    def _sites(sf):
        """(line, name, is_cli_choice) policy-name string references."""
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn_name = _call_name(node)
            for kw in node.keywords:
                if kw.arg == "trigger_policy" or (
                        kw.arg == "policy" and fn_name == "AuditConfig"):
                    s = _const_str(kw.value)
                    if s is not None:
                        yield kw.value.lineno, s, False
                elif (kw.arg == "choices" and fn_name == "add_argument"
                      and node.args
                      and _const_str(node.args[0]) == "--trigger-policy"
                      and isinstance(kw.value, (ast.List, ast.Tuple))):
                    for el in kw.value.elts:
                        s = _const_str(el)
                        if s is not None:
                            yield el.lineno, s, True

    def check(self, files):
        from eventgrad_tpu_torch.parallel import policy as policy_lib

        out = []
        cli_rel, cli_choices = None, set()
        for sf in files:
            if not _in_package(sf):
                continue
            for line, name, is_choice in self._sites(sf):
                if is_choice:
                    cli_rel = sf.rel
                    cli_choices.add(name)
                if name not in policy_lib.POLICIES:
                    out.append(self._v(
                        sf, line,
                        f"trigger policy '{name}' is not a registry entry "
                        "— register it in parallel/policy.py POLICIES "
                        f"(known: {', '.join(sorted(policy_lib.POLICIES))})"))
        if cli_rel is not None:
            for reg in sorted(set(policy_lib.POLICIES) - cli_choices):
                out.append(Violation(
                    self.name, cli_rel, 1,
                    f"registered trigger policy '{reg}' is missing from "
                    "--trigger-policy choices — a policy the CLI can't "
                    "name is dead surface; add it to the flag (or drop "
                    "the registry entry)"))
        return out


class CarrierDtypeDeclared(Rule):
    """The resident dtype of EventState's receive buffers is declared
    once, by `parallel/arena.py` `alloc_event_bufs` (the carrier arenas
    and their int8 scales together). An ad-hoc `.to(...)` inside a
    `bufs=` / `buf_scales=` keyword re-dtypes them outside that
    declaration; and the EventState owner must still allocate through the
    helper, or the rule covers nothing."""

    name = "carrier-dtype-declared"
    OWNER = f"{PACKAGE}/parallel/events.py"
    HELPER = "alloc_event_bufs"
    BUF_KWARGS = frozenset({"bufs", "buf_scales"})

    def check(self, files):
        out = []
        owner_seen = owner_routes = False
        for sf in files:
            if not _in_package(sf):
                continue
            owner = sf.rel == self.OWNER
            owner_seen = owner_seen or owner
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                if owner and _call_name(node) == self.HELPER:
                    owner_routes = True
                for kw in node.keywords:
                    if kw.arg not in self.BUF_KWARGS:
                        continue
                    for sub in ast.walk(kw.value):
                        if (isinstance(sub, ast.Call)
                                and isinstance(sub.func, ast.Attribute)
                                and sub.func.attr == "to"):
                            out.append(self._v(
                                sf, sub.lineno,
                                f"ad-hoc .to() inside an EventState "
                                f"{kw.arg}= site — the resident dtype of "
                                "the receive buffers is declared once by "
                                "parallel/arena.py alloc_event_bufs "
                                "(carrier layout + dequant scales "
                                "together)"))
        if owner_seen and not owner_routes:
            out.append(Violation(
                self.name, self.OWNER, 1,
                "EventState's owner no longer allocates its buffers "
                "through alloc_event_bufs — the one place the resident "
                "dtype (and its scales) is declared"))
        return out


class ExitCodeLiterals(Rule):
    """The exit codes are a contract; the package spells them
    `exitcodes.<NAME>`, never by value."""

    name = "exit-code-literals"
    CODES = frozenset(exitcodes.EXIT_CODE_NAMES)
    ALLOWED = f"{PACKAGE}/exitcodes.py"

    def check(self, files):
        out = []
        for sf in files:
            if not _in_package(sf) or sf.rel == self.ALLOWED:
                continue
            for node in ast.walk(sf.tree):
                if (isinstance(node, ast.Constant)
                        and type(node.value) is int
                        and node.value in self.CODES):
                    out.append(self._v(
                        sf, node.lineno,
                        f"exit-code literal {node.value} outside "
                        f"exitcodes.py — import {PACKAGE}.exitcodes "
                        f"({exitcodes.EXIT_CODE_NAMES[node.value]}) "
                        "instead of re-declaring the contract by value"))
        return out


class OsExitConfined(Rule):
    """`os._exit` belongs to the crashpoint engine."""

    name = "os-exit-confined"
    OWNER = f"{PACKAGE}/chaos/crashpoint.py"

    def check(self, files):
        out = []
        for sf in files:
            if not _in_package(sf) or sf.rel == self.OWNER:
                continue
            for node in ast.walk(sf.tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "_exit"
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "os"):
                    out.append(self._v(
                        sf, node.lineno,
                        "os._exit outside chaos/crashpoint.py — the hard-"
                        "kill model belongs to the crashpoint engine "
                        "(raise, or register a crash site)"))
        return out


class CrashpointInstrumented(Rule):
    """Every registered crash site is instrumented at exactly one literal
    `crashpoint.hit("<name>")` call, except a declared waiting site,
    which must stay uninstrumented until its seam is ported."""

    name = "crashpoint-instrumented"
    OWNER = f"{PACKAGE}/chaos/crashpoint.py"
    #: registered sites whose seam the port has not got yet, with the
    #: ROADMAP item that brings it (none: every site is instrumented)
    WAITING: Dict[str, str] = {}

    def check(self, files):
        from eventgrad_tpu_torch.chaos import crashpoint

        out = []
        used: Dict[str, List[str]] = {}
        for sf in files:
            if not _in_package(sf) or sf.rel == self.OWNER:
                continue
            for node in ast.walk(sf.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "hit"
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "crashpoint"):
                    continue
                site = _const_str(node.args[0]) if node.args else None
                if site is None:
                    out.append(self._v(
                        sf, node.lineno,
                        "crashpoint.hit() must take a string literal "
                        "(the instrumentation lint counts literal sites)"))
                    continue
                used.setdefault(site, []).append(sf.rel)
        unregistered = set(used) - set(crashpoint.SITES)
        dead = set(crashpoint.SITES) - set(used) - set(self.WAITING)
        dupes = {n: fs for n, fs in used.items() if len(fs) > 1}
        stale = {n for n in self.WAITING
                 if n in used or n not in crashpoint.SITES
                 or "ROADMAP queue 1, item" not in self.WAITING[n]}
        if unregistered:
            out.append(Violation(
                self.name, PACKAGE, 1,
                f"unregistered crashpoint names instrumented: "
                f"{sorted(unregistered)}"))
        if dead:
            out.append(Violation(
                self.name, PACKAGE, 1,
                f"registered crashpoints with NO instrumented site: "
                f"{sorted(dead)}"))
        if dupes:
            out.append(Violation(
                self.name, PACKAGE, 1,
                f"crashpoints instrumented at more than one site: {dupes}"))
        if stale:
            out.append(Violation(
                self.name, PACKAGE, 1,
                f"waiting crashpoints {sorted(stale)}: a waiting site is "
                "registered, uninstrumented and names its ROADMAP item"))
        return out


class WallClockConfined(Rule):
    """Wall-clock timing belongs to the observability layer: `obs/` owns
    durations (Registry spans). A stray `time.perf_counter()` elsewhere in
    the package is a timing fragment the span trace cannot see. The files
    that read the clock for a metric of their own are exempt BY NAME with
    the reason on record; each exemption is honesty-checked (the file must
    still read the clock, or the exemption has gone stale)."""

    name = "wall-clock-confined"
    ALLOWED_PREFIX = f"{PACKAGE}/obs/"
    #: banned attribute reads on the `time` module (calls and aliases)
    BANNED = frozenset({
        "time", "perf_counter", "perf_counter_ns", "monotonic",
        "monotonic_ns",
    })
    EXEMPT = {
        f"{PACKAGE}/train/loop.py":
            "the records' wall_s (the epoch's steps to its synchronize) "
            "and the preemption drain_s: the numbers the dispatch_block "
            "span wraps, record fields older than the registry",
        f"{PACKAGE}/utils/metrics.py":
            "JsonlLogger's per-record `ts` wall TIMESTAMP (not a duration "
            "measurement)",
        f"{PACKAGE}/ops/build.py":
            "the kernel build's seconds (nvcc, link) in the build record "
            "the chip smoke prints",
        f"{PACKAGE}/analysis/audit.py":
            "each audited cell's wall_s in the audit record (the JAX "
            "record's field)",
        f"{PACKAGE}/utils/frontier.py":
            "the frontier legs' seconds in their artifact",
        f"{PACKAGE}/utils/realdata.py":
            "the real-data legs' seconds in their artifact",
        f"{PACKAGE}/utils/straggler.py":
            "the straggler legs' seconds in their artifact",
        f"{PACKAGE}/utils/profile_step.py":
            "the profiled step's host wall beside the profiler's device "
            "times (the host-bound share)",
        f"{PACKAGE}/utils/chaos_sweep.py":
            "the sweep's per-leg seconds and its total in the artifact",
        f"{PACKAGE}/utils/crash_matrix.py":
            "the child processes' deadlines and each cell's seconds",
        f"{PACKAGE}/utils/integrity_sweep.py":
            "the sweep's per-leg seconds in the artifact",
        f"{PACKAGE}/chaos/membership.py":
            "each membership transition's apply_s in its info record "
            "(the JAX record's field, same vintage as loop.py's wall_s)",
        f"{PACKAGE}/utils/profiling.py":
            "timed_steps: the first call's seconds and, off the card, the "
            "host-clock step times (the JAX helper's fields)",
        f"{PACKAGE}/supervise.py":
            "the heartbeat: a child's launch time against the newest mtime "
            "under its log or checkpoint dir, and the restart window's "
            "clock",
        f"{PACKAGE}/utils/soak.py":
            "the soak's seconds in its record (the JAX artifact's wall_s)",
    }

    def _hits(self, sf: SourceFile):
        # every local name the time module is bound to, so an alias
        # (`import time as clock`) cannot dodge the rule
        aliases = {"time"}
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        aliases.add(a.asname or "time")
        for node in ast.walk(sf.tree):
            if (isinstance(node, ast.Attribute)
                    and node.attr in self.BANNED
                    and isinstance(node.value, ast.Name)
                    and node.value.id in aliases):
                yield node.lineno
            elif (isinstance(node, ast.ImportFrom)
                  and node.module == "time"
                  and any(a.name in self.BANNED for a in node.names)):
                yield node.lineno

    def check(self, files):
        out = []
        for sf in files:
            if not _in_package(sf) or sf.rel.startswith(self.ALLOWED_PREFIX):
                continue
            hits = list(self._hits(sf))
            if sf.rel in self.EXEMPT:
                if not hits:
                    out.append(self._v(
                        sf, 1,
                        "exempt file no longer reads the wall clock — drop "
                        "it from WallClockConfined.EXEMPT "
                        f"({self.EXEMPT[sf.rel]})"))
                continue
            for line in hits:
                out.append(self._v(
                    sf, line,
                    "wall-clock timing outside obs/ — spans are the one "
                    "timing API (obs.Registry.span); a metric that needs "
                    "its own clock gets a named EXEMPT entry"))
        return out


class TelemetryCounterLedgered(Rule):
    """The message ledger's disposition counters move ONLY through
    `obs/ledger.py` `ledger_update`: that single site is what makes the
    conservation laws auditable (`utils/ledger_audit.py`). A path that
    adds to `counts` / `queue` / `late_queue` in place can double-count or
    skip a fate, the leaks the auditor exists to catch. Outside the
    helper, an in-place add on a ledger counter (`index_add_`,
    `scatter_add_`, `add_`, `index_put_`, `+=`, `[...] +=`) flags; a
    `ledger=` keyword must be a pass-through (a name, an attribute, None,
    or a call of the helper, `init` or `replace`). The stale direction
    flags too: `ledger_update` must still add to the counters itself."""

    name = "telemetry-counter-ledgered"
    OWNER = f"{PACKAGE}/obs/ledger.py"
    HELPER = "ledger_update"
    COUNTERS = frozenset({"counts", "queue", "late_queue"})
    INPLACE = frozenset({"index_add_", "scatter_add_", "add_", "index_put_",
                         "put_", "scatter_"})
    ALLOWED_CALLS = frozenset({"ledger_update", "init", "replace"})

    @staticmethod
    def _chain(node) -> List[str]:
        """Names along `a.b.c` / `a.b[i]` -> ['a', 'b', 'c']."""
        parts = []
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            if isinstance(node, ast.Attribute):
                parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
        return parts[::-1]

    def _is_counter(self, node) -> bool:
        chain = self._chain(node)
        return bool(chain) and chain[-1] in self.COUNTERS and (
            any("ledger" in p or p == "led" for p in chain[:-1]))

    def _mutations(self, tree, skip=None):
        """(line) of every in-place add on a ledger counter, outside the
        function node `skip`."""
        skipped = set()
        if skip is not None:
            skipped = {id(n) for n in ast.walk(skip)}
        for node in ast.walk(tree):
            if id(node) in skipped:
                continue
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self.INPLACE
                    and self._is_counter(node.func.value)):
                yield node.lineno
            elif (isinstance(node, ast.AugAssign)
                  and self._is_counter(node.target)):
                yield node.lineno

    def check(self, files):
        out = []
        owner_adds = None
        for sf in files:
            if not _in_package(sf):
                continue
            helper = None
            if sf.rel == self.OWNER:
                helper = next((n for n in ast.walk(sf.tree)
                               if isinstance(n, ast.FunctionDef)
                               and n.name == self.HELPER), None)
                owner_adds = helper is not None and any(
                    isinstance(n, ast.BinOp) and isinstance(n.op, ast.Add)
                    and any(isinstance(o, ast.Name) and o.id == "counts"
                            for o in (n.left, n.right))
                    for n in ast.walk(helper))
            for line in self._mutations(sf.tree, skip=helper):
                out.append(self._v(
                    sf, line,
                    "in-place add on the message ledger's counters outside "
                    "obs.ledger.ledger_update — disposition counters move "
                    "only through the helper (the one site the "
                    "conservation auditor can hold to account)"))
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                for kw in node.keywords:
                    if kw.arg != "ledger":
                        continue
                    v = kw.value
                    if isinstance(v, (ast.Name, ast.Attribute)):
                        continue
                    if isinstance(v, ast.Constant) and v.value is None:
                        continue
                    if (isinstance(v, ast.Call)
                            and isinstance(v.func, ast.Attribute)
                            and v.func.attr in self.ALLOWED_CALLS):
                        continue
                    if (isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                            and v.func.id == self.HELPER):
                        continue
                    out.append(self._v(
                        sf, v.lineno,
                        "computed ledger= value — disposition accounting "
                        "lives in obs.ledger.ledger_update; pass the "
                        "branch's raw observables (ledger_inputs=) "
                        "instead of counter math at the call site"))
        if owner_adds is False:
            out.append(Violation(
                self.name, self.OWNER, 1,
                "obs/ledger.py's ledger_update no longer adds to the "
                "disposition counters itself — the helper is the ONE place "
                "message counters move; without it this rule covers "
                "nothing"))
        return out


#: the port's test files the process-group rules read
_PORT_TEST_PREFIX = "tests/test_torch_"
#: the one helper that starts process groups and owns their skip marker
DIST_HELPER = "_torch_dist"
DIST_MARKER = "requires_gloo"
#: test files exempt from process-group-marker, by base name (none)
DIST_EXEMPT: frozenset = frozenset()


def _is_port_test(sf: SourceFile) -> bool:
    return sf.rel.startswith(_PORT_TEST_PREFIX) and sf.rel.endswith(".py")


def _starts_group(sf: SourceFile) -> bool:
    """The file imports the group helper or calls init_process_group."""
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ImportFrom) and node.module == DIST_HELPER:
            return True
        if isinstance(node, ast.Import) and any(
                a.name == DIST_HELPER for a in node.names):
            return True
        if (isinstance(node, ast.Call)
                and _call_name(node) == "init_process_group"):
            return True
    return False


class ProcessGroupMarker(Rule):
    """A port test that starts a process group takes the shared skip
    marker (the JAX lint's shard-map-marker)."""

    name = "process-group-marker"
    scope = "tests"

    def check(self, files):
        out = []
        for sf in files:
            if not _is_port_test(sf) or os.path.basename(sf.rel) in DIST_EXEMPT:
                continue
            if not _starts_group(sf):
                continue
            if not any(isinstance(n, ast.ImportFrom)
                       and n.module == DIST_HELPER
                       and any(a.name == DIST_MARKER for a in n.names)
                       for n in ast.walk(sf.tree)):
                out.append(self._v(
                    sf, 1,
                    f"{os.path.basename(sf.rel)} starts a process group "
                    f"without importing the shared `{DIST_MARKER}` marker "
                    f"from tests/{DIST_HELPER}.py; add `from {DIST_HELPER} "
                    f"import {DIST_MARKER}` instead of re-spelling the "
                    "skipif"))
        return out


def _mentions_gloo(node) -> bool:
    for n in ast.walk(node):
        text = (n.attr if isinstance(n, ast.Attribute)
                else n.id if isinstance(n, ast.Name)
                else n.value if isinstance(n, ast.Constant)
                and isinstance(n.value, str) else "")
        if "gloo" in text.lower():
            return True
    return False


class ProcessGroupRespell(Rule):
    """No port test re-spells the process-group skip (the JAX lint's
    shard-map-respell)."""

    name = "process-group-respell"
    scope = "tests"

    def check(self, files):
        out = []
        for sf in files:
            if not _is_port_test(sf):
                continue
            for node in ast.walk(sf.tree):
                if (isinstance(node, ast.Call)
                        and _call_name(node) == "skipif"
                        and any(_mentions_gloo(a) for a in node.args)):
                    out.append(self._v(
                        sf, node.lineno,
                        f"{os.path.basename(sf.rel)} re-spells the process-"
                        f"group skipif; use `{DIST_MARKER}` from "
                        f"tests/{DIST_HELPER}.py (single definition, single "
                        "reason string)"))
        return out


class ProcessGroupExemptHonest(Rule):
    """The exemption list stays honest: every exempt file still exists
    and still starts a process group (the JAX lint's
    shard-map-exempt-honest)."""

    name = "process-group-exempt-honest"
    scope = "tests"
    EXEMPT = DIST_EXEMPT

    def check(self, files):
        out = []
        by_name = {os.path.basename(sf.rel): sf for sf in files
                   if _is_port_test(sf)}
        for name in sorted(self.EXEMPT):
            sf = by_name.get(name)
            if sf is None:
                out.append(Violation(self.name, f"tests/{name}", 1,
                                     f"exempt file {name} no longer exists"))
            elif not _starts_group(sf):
                out.append(self._v(
                    sf, 1,
                    f"exempt file {name} no longer starts a process group "
                    "— drop it from DIST_EXEMPT"))
        return out


RULES: Sequence[Rule] = (
    NoHostSyncInTraced(),
    KernelRegistered(),
    TriggerPolicyRegistered(),
    CarrierDtypeDeclared(),
    ExitCodeLiterals(),
    OsExitConfined(),
    CrashpointInstrumented(),
    WallClockConfined(),
    TelemetryCounterLedgered(),
    ProcessGroupMarker(),
    ProcessGroupRespell(),
    ProcessGroupExemptHonest(),
)


def run(
    rules: Optional[Iterable[Rule]] = None,
    root: str = REPO_ROOT,
    files: Optional[Sequence[SourceFile]] = None,
) -> List[Violation]:
    """Run every rule over the port's sources, the test-scoped rules over
    the port's test files (or every rule over an injected file set: the
    tests feed seeded violations through here)."""
    scoped = {"package": files, "tests": files}
    if files is None:
        scoped = {"package": collect_sources(root),
                  "tests": [sf for sf in collect_sources(root, ("tests",))
                            if _is_port_test(sf)]}
    out: List[Violation] = []
    for rule in rules if rules is not None else RULES:
        out.extend(rule.check(scoped[rule.scope]))
    return out


def main(argv=None) -> int:
    violations = run()
    for v in violations:
        print(str(v), file=sys.stderr)
    print(f"lint: {len(RULES)} rules, {len(violations)} violations")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
