"""Pass 3 — repo-invariant lint over the port: AST enforcement of rules
the code states only in comments.

Port of `repro/analysis/lint.py`.  The rule classes over
`src/repro_torch`:

  scheduler-no-framework  serve/scheduler.py is the framework-free
                          policy layer (a copy of the reference's): no
                          `torch` and no `jax` import, so scheduling is
                          unit-tested with scripted fakes and the
                          policy never touches a device.  (The
                          reference's `scheduler-no-jax`.)
  scheduler-determinism   the round-robin path must be deterministic:
                          no `time.time`/`time.time_ns`, no `random`,
                          `numpy.random`, `secrets`, or `uuid` in
                          serve/scheduler.py (`repro_torch.obs.timer`
                          is the sanctioned clock — it only feeds
                          latency reports, never ordering).
  no-raw-timing           modules under serve/ and query/ must not call
                          `time.perf_counter` (or `perf_counter_ns`,
                          `monotonic`, `monotonic_ns`, `process_time`)
                          directly: latency measured ad hoc never
                          reaches the metrics registry or the trace.
                          `repro_torch.obs` (`timer()`, `Timer`, tracer
                          spans) is the one clock; obs/ itself is the
                          sanctioned home of the raw calls.
  label-coverage          every identity/serialization surface that two
                          label variants of one skeleton could alias
                          through must keep referencing the labels
                          field: `canonical_key` + `_wl_cells`
                          (query/canon.py), `Pattern.to_dict` +
                          `_automorphisms_cached` (core/pattern.py),
                          `plan_to_dict` (core/plan.py, vlabels),
                          `fingerprint` (graph/csr.py), and the store's
                          `_record_labeled`; the lint fails if the
                          function loses its labels reference OR
                          disappears outright.
  no-stale-fingerprint    modules under serve/ and query/ must not stash
                          a graph fingerprint on long-lived object state
                          (`self.fp = graph.fingerprint`): on a live
                          engine the graph mutates between rounds, so a
                          captured fingerprint keys new-epoch counts
                          under an old-epoch identity.  Hold an
                          `EpochStamp` (live/epoch.py) instead.  Locals
                          are fine; only attribute stores are flagged.
  no-reference-import     the port is a package of its own: no module
                          imports `jax`, `jaxlib` or the reference
                          package `repro` (its tests alone import both).
                          Also applied to the port's entry files beside
                          the package (`chip_smoke.py`,
                          `examples/torch_*.py`).
  kernel-through-ops      kernels are loaded and built only under
                          kernels/: `ctypes` (and its `CDLL` loads),
                          the `nvcc` build (kernels/nvcc.py) and
                          `torch.utils.cpp_extension` appear nowhere
                          else, and every other module reaches a kernel
                          only through `kernels/ops.py` (which routes a
                          CUDA tensor to the kernel and a CPU tensor to
                          the plain version) — importing `kernels.ref`,
                          the plain versions themselves, is allowed.

The reference's `compat-only-drift` and `no-tracer-concretize` have no
counterpart: the port has no compatibility shim over drifting APIs, and
it traces nothing (eager PyTorch; its kernels are CUDA C++, not
traced Python bodies).

Pure `ast` — no imports of the linted modules, so a module that fails
to import is still lintable (and a syntax error becomes a finding).
"""
from __future__ import annotations

import ast
from pathlib import Path

from .findings import ERROR, Finding

_NONDETERMINISTIC_MODULES = {"random", "secrets", "uuid"}
_NONDETERMINISTIC_ATTRS = {
    "time.time", "time.time_ns", "numpy.random", "np.random",
    "os.urandom",
}
_FRAMEWORKS = {"torch", "jax"}

# raw clocks forbidden outside repro_torch/obs in the serving + query layers
_RAW_TIMING_NAMES = {
    "perf_counter", "perf_counter_ns", "monotonic", "monotonic_ns",
    "process_time", "process_time_ns",
}
_RAW_TIMING_ATTRS = {f"time.{n}" for n in _RAW_TIMING_NAMES}

# the reference's packages, which the port never imports
_REFERENCE_ROOTS = {"jax", "jaxlib", "repro"}

# kernels/ modules any module may import: the wrappers and the plain
# versions of the kernels
_KERNEL_FRONT = {"ops", "ref"}

# label-coverage: (path suffix) -> {function name: required token}.
_LABEL_SURFACES: dict[str, dict[str, str]] = {
    "core/pattern.py": {"to_dict": "labels",
                        "_automorphisms_cached": "labels"},
    "query/canon.py": {"canonical_key": "labels", "_wl_cells": "labels"},
    "core/plan.py": {"plan_to_dict": "vlabels"},
    "graph/csr.py": {"fingerprint": "labels"},
    "query/store.py": {"_record_labeled": "vlabels"},
}


def _in_timed_scope(rel: str) -> bool:
    """True for modules under serve/ or query/ (where `no-raw-timing`
    applies), excluding obs/ — the one sanctioned home of the raw clock
    calls."""
    p = rel.replace("\\", "/")
    if "/obs/" in p or p.startswith("obs/"):
        return False
    return any(f"/{d}/" in p or p.startswith(f"{d}/")
               for d in ("serve", "query"))


def _in_kernels(rel: str) -> bool:
    p = rel.replace("\\", "/")
    return "/kernels/" in p or p.startswith("kernels/")


def _err(rule: str, loc: str, msg: str) -> Finding:
    return Finding(ERROR, rule, loc, msg)


def _dotted(node: ast.AST) -> str | None:
    """'torch.cuda.synchronize' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _mentions_fingerprint(node: ast.AST) -> bool:
    """Does this expression read a `.fingerprint` attribute (property or
    method) or call/reference `graph_fingerprint`?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "fingerprint":
            return True
        if isinstance(sub, ast.Name) and sub.id == "graph_fingerprint":
            return True
    return False


def _check_stale_fingerprint(node, rel: str) -> list[Finding]:
    """no-stale-fingerprint: an attribute store in serve/query whose
    value derives from a fingerprint captures graph identity on state
    that outlives the round — stale the moment a live engine mutates."""
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    if not any(isinstance(sub, ast.Attribute)
               for t in targets for sub in ast.walk(t)):
        return []
    value = node.value
    if value is None or not _mentions_fingerprint(value):
        return []
    return [_err(
        "no-stale-fingerprint", f"{rel}:{node.lineno}",
        "fingerprint captured on long-lived state in the serve/query "
        "path; on a live engine it goes stale at the next mutation "
        "round — hold an EpochStamp (repro_torch.live.epoch) and read "
        "fingerprints through it at use sites instead")]


def _references_token(fn: ast.AST, token: str) -> bool:
    """Does the function body mention `token` as an attribute, name, or
    string literal (dict key)?"""
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and node.attr == token:
            return True
        if isinstance(node, ast.Name) and node.id == token:
            return True
        if isinstance(node, ast.Constant) and node.value == token:
            return True
        if isinstance(node, ast.keyword) and node.arg == token:
            return True
    return False


def _check_label_surfaces(tree: ast.Module, rel: str,
                          surfaces: dict[str, str]) -> list[Finding]:
    found: set[str] = set()
    out: list[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        token = surfaces.get(node.name)
        if token is None:
            continue
        found.add(node.name)
        if not _references_token(node, token):
            out.append(_err(
                "label-coverage", f"{rel}:{node.lineno}",
                f"{node.name}() no longer references {token!r}: labeled "
                f"patterns would alias their unlabeled skeletons through "
                f"this identity/serialization surface"))
    for name in sorted(set(surfaces) - found):
        out.append(_err(
            "label-coverage", rel,
            f"expected label-carrying function {name}() not found; if it "
            f"was renamed, update _LABEL_SURFACES to keep the labels "
            f"field pinned to the new surface"))
    return out


def _imported_modules(node) -> list[str]:
    """Absolute module names an import statement names (for `from X
    import a, b` also X.a, X.b, since a, b may be modules); relative
    imports as '.'-prefixed names."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    base = "." * node.level + (node.module or "")
    sep = "" if base.endswith(".") else "."
    return [base] + [f"{base}{sep}{a.name}" for a in node.names]


def _kernel_module(name: str) -> str | None:
    """The kernels/ module an import names ('ops', 'intersect', ...), or
    None when it names none."""
    parts = [p for p in name.split(".") if p]
    if "kernels" not in parts:
        return None
    rest = parts[parts.index("kernels") + 1:]
    return rest[0] if rest else ""


def _check_reference_import(node, loc: str) -> list[Finding]:
    if isinstance(node, ast.ImportFrom) and node.level:
        return []
    roots = ({a.name.split(".")[0] for a in node.names}
             if isinstance(node, ast.Import)
             else {(node.module or "").split(".")[0]})
    return [_err("no-reference-import", loc,
                 f"imports {root!r}: the port imports neither JAX nor the "
                 f"reference package (only its tests import both)")
            for root in sorted(roots & _REFERENCE_ROOTS)]


def _check_kernel_import(node, loc: str) -> list[Finding]:
    out: list[Finding] = []
    names = _imported_modules(node)
    roots = {n.lstrip(".").split(".")[0] for n in names}
    if "ctypes" in roots:
        out.append(_err("kernel-through-ops", loc,
                        "ctypes outside kernels/: libraries are loaded "
                        "only by the kernels' own modules"))
    if any(n == "torch.utils.cpp_extension"
           or n.startswith("torch.utils.cpp_extension.") for n in names):
        out.append(_err("kernel-through-ops", loc,
                        "torch.utils.cpp_extension outside kernels/: "
                        "kernels are built only under kernels/"))
    # `from ..kernels import ops` names kernels/ itself and its module
    # ops: only the modules named after the package count
    mods = {_kernel_module(n) for n in names} - {None, ""}
    for mod in sorted(mods - _KERNEL_FRONT):
        out.append(_err(
            "kernel-through-ops", loc,
            f"imports kernels.{mod}: modules outside kernels/ reach a "
            f"kernel only through kernels/ops.py"
            + (" (nvcc builds happen only under kernels/)"
               if mod == "nvcc" else "")))
    return out


_PROCESS_CALLS = {"run", "Popen", "call", "check_call", "check_output",
                  "system"}


def _runs_nvcc(call: ast.Call) -> bool:
    """A process call (subprocess.*, os.system) whose arguments name
    nvcc."""
    name = _dotted(call.func) or ""
    if name.split(".")[-1] not in _PROCESS_CALLS:
        return False
    return any(isinstance(sub, ast.Constant) and isinstance(sub.value, str)
               and sub.value.split("/")[-1].split(" ")[0] == "nvcc"
               for arg in call.args for sub in ast.walk(arg))


def lint_source(src: str, rel: str, *,
                rules: frozenset | None = None) -> list[Finding]:
    """Lint one module's source; `rel` is the repo-relative path used in
    finding locations and to select per-file rules.  `rules` limits the
    pass to those rule names (None: all)."""
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [_err("syntax", f"{rel}:{e.lineno or 0}",
                     f"does not parse: {e.msg}")]

    def on(rule: str) -> bool:
        return rules is None or rule in rules

    posix = rel.replace("\\", "/")
    is_scheduler = posix.endswith("serve/scheduler.py")
    is_timed = _in_timed_scope(rel)
    in_kernels = _in_kernels(rel)
    out: list[Finding] = []
    if on("label-coverage"):
        for suffix, surfaces in _LABEL_SURFACES.items():
            if posix.endswith(suffix):
                out += _check_label_surfaces(tree, rel, surfaces)

    for node in ast.walk(tree):
        loc = f"{rel}:{getattr(node, 'lineno', 0)}"

        if isinstance(node, (ast.Import, ast.ImportFrom)):
            if on("no-reference-import"):
                out += _check_reference_import(node, loc)
            if on("kernel-through-ops") and not in_kernels:
                out += _check_kernel_import(node, loc)
            absolute = (isinstance(node, ast.Import)
                        or not node.level)
            roots = ({a.name.split(".")[0] for a in node.names}
                     if isinstance(node, ast.Import)
                     else {(node.module or "").split(".")[0]})
            if not absolute:
                roots = set()
            if is_scheduler and on("scheduler-no-framework"):
                for root in sorted(roots & _FRAMEWORKS):
                    out.append(_err(
                        "scheduler-no-framework", loc,
                        f"imports {root}: the scheduler is the "
                        f"framework-free policy layer by contract"))
            if is_scheduler and on("scheduler-determinism"):
                for root in sorted(roots & _NONDETERMINISTIC_MODULES):
                    out.append(_err(
                        "scheduler-determinism", loc,
                        f"imports {root}: nondeterminism in the "
                        f"round-robin path breaks the tested "
                        f"interleaving"))
            if (is_timed and on("no-raw-timing")
                    and isinstance(node, ast.ImportFrom)
                    and node.module == "time" and not node.level):
                for a in node.names:
                    if a.name in _RAW_TIMING_NAMES:
                        out.append(_err(
                            "no-raw-timing", loc,
                            f"from time import {a.name}: raw timing in "
                            f"the serve/query path — use repro_torch.obs "
                            f"(timer()/Timer or a tracer span) so the "
                            f"measurement reaches the metrics registry"))

        elif isinstance(node, ast.Attribute):
            name = _dotted(node)
            if name is None:
                continue
            if is_scheduler and on("scheduler-no-framework") \
                    and name.split(".")[0] in _FRAMEWORKS:
                out.append(_err(
                    "scheduler-no-framework", loc,
                    f"{name}: the scheduler must not touch a framework"))
            if is_scheduler and on("scheduler-determinism") \
                    and name in _NONDETERMINISTIC_ATTRS:
                out.append(_err(
                    "scheduler-determinism", loc,
                    f"{name}: nondeterministic call in the round-robin "
                    f"path (repro_torch.obs.timer is the sanctioned "
                    f"clock)"))
            if is_timed and on("no-raw-timing") \
                    and name in _RAW_TIMING_ATTRS:
                out.append(_err(
                    "no-raw-timing", loc,
                    f"{name}: raw timing in the serve/query path — use "
                    f"repro_torch.obs (timer()/Timer or a tracer span) "
                    f"so the measurement reaches the metrics registry"))
            if not in_kernels and on("kernel-through-ops") \
                    and name.split(".")[-1] == "CDLL":
                out.append(_err(
                    "kernel-through-ops", loc,
                    f"{name}: a library load outside kernels/"))

        elif isinstance(node, ast.Call):
            if not in_kernels and on("kernel-through-ops") \
                    and _runs_nvcc(node):
                out.append(_err(
                    "kernel-through-ops", loc,
                    "runs nvcc outside kernels/: kernels are built only "
                    "by kernels/nvcc.py"))

        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            if is_timed and on("no-stale-fingerprint"):
                out += _check_stale_fingerprint(node, rel)

    return out


def lint_path(path: Path, root: Path, *,
              rules: frozenset | None = None) -> list[Finding]:
    rel = str(path.relative_to(root))
    try:
        src = path.read_text()
    except OSError as e:
        return [_err("syntax", rel, f"unreadable: {e}")]
    return lint_source(src, rel, rules=rules)


# the port's files beside the package, held to no-reference-import
ENTRY_FILES = ("chip_smoke.py", "examples/torch_*.py")


def lint_tree(root: Path | str) -> list[Finding]:
    """Lint every Python module under `<root>/src/repro_torch` (or
    `root` itself when it already points inside a source tree), and the
    port's entry files at `root` (`ENTRY_FILES`) under
    `no-reference-import`."""
    root = Path(root)
    base = root / "src" / "repro_torch"
    if not base.is_dir():
        base = root
    out: list[Finding] = []
    for path in sorted(base.rglob("*.py")):
        out += lint_path(path, root)
    entries = sorted({p for pat in ENTRY_FILES for p in root.glob(pat)})
    for path in entries:
        out += lint_path(path, root,
                         rules=frozenset({"no-reference-import"}))
    return out
