"""Pass 2 — static kernel-contract checking for K1's CUDA entries.

Port of `repro/analysis/kernel_contracts.py`, retargeted from the
reference's Pallas kernel at the entries the executor calls on a card:
`ops.level_expand_rows` (K1's count and signed modes, candidates read
from their CSR row), `ops.level_expand_compact` (mask mode with the
level's stream compaction) and the reference-shaped `ops.level_expand`
(a gathered candidate window).  The CUDA source states its limits in
`#define`s and its launchers refuse what exceeds them with an error
code; the executor's offsets are int32.  This pass proves, for a graph
shape and an `ExecutorConfig`, that every call shape the executor
generates — one spec per degree bucket and mode — stays inside them:

  kernel-int32-offset  the padded flat CSR length `2m + flat_gather_pad()`,
                       `|V|`, the furthest read of a candidate row
                       (flat_len + window) and the compaction's capacity
                       fit int32 (`ops.py`'s int32 operands);
  kernel-preds         P ≤ `ops.MAX_PREDS`, the row-sourced kernels'
                       LR_MAX_PREDS (csrc/level_expand.cu:225);
  kernel-dirs          comparisons ≤ `ops.MAX_DIRS`, LE_MAX_DIRS (:45);
  kernel-window        a positive window, each bucket's width within it,
                       and a signed tail at the bucket's width.

`deep=True` is the counterpart of the reference's `jax.eval_shape` +
jaxpr walk: it runs each entry's own input checks
(`ops.validate_level_expand`, `validate_level_expand_rows`,
`validate_level_expand_compact`: shapes, dtypes, devices and limits,
reading no values) on `meta` tensors of every spec, so drift between
the executor's call shapes and the wrappers' contract shows without a
card, and nothing is launched.
"""
from __future__ import annotations

from dataclasses import dataclass

from .findings import ERROR, WARNING, Finding

INT32_MAX = 2**31 - 1
ENTRIES = ("rows", "compact", "window")


def _err(rule: str, loc: str, msg: str) -> Finding:
    return Finding(ERROR, rule, loc, msg)


@dataclass(frozen=True)
class LevelExpandSpec:
    """Static facets of one K1 call site.

    `entry` names the wrapper: ``rows`` (`level_expand_rows`, count
    mode, or signed with `Q` > 0 prefix columns), ``compact``
    (`level_expand_compact`, mask mode into a frontier of `capacity`
    rows) or ``window`` (`level_expand`, mask mode over a gathered
    [B, width] window).  `B` is the rows of one launch (the executor
    launches at most `SLICE_ENTRIES // width` rows at once); `flat_len`
    is the UNPADDED flat CSR length (2m)."""

    B: int                    # frontier rows of one launch
    width: int                # candidate columns (the bucket's width)
    P: int                    # predecessor rows searched
    E: int = 0                # comparisons (restrictions, injectivity)
    Q: int = 0                # signed-mode prefix columns (rows entry)
    window: int = 0           # static row-length bound (graph max degree)
    flat_len: int = 0         # unpadded flat CSR length (2m)
    capacity: int = 0         # compaction's frontier capacity C
    entry: str = "rows"
    label: str = "level_expand"

    @property
    def padded_len(self) -> int:
        """The flat array's length on the device, sentinels included."""
        from ..kernels.ops import flat_gather_pad

        return self.flat_len + flat_gather_pad()

    @property
    def mode(self) -> str:
        if self.entry == "rows":
            return "signed" if self.Q else "count"
        return "mask"


def check_spec(spec: LevelExpandSpec) -> list[Finding]:
    """Contract proofs that need no tensors at all."""
    from ..kernels.ops import MAX_DIRS, MAX_PREDS, flat_gather_pad

    loc = spec.label
    out: list[Finding] = []
    if spec.entry not in ENTRIES:
        out.append(_err("kernel-entry", loc,
                        f"entry {spec.entry!r} not one of {ENTRIES}"))
        return out
    if spec.P < 1:
        out.append(_err("kernel-preds", loc,
                        f"P={spec.P}: K1 needs a predecessor row"))
    if spec.entry != "window" and spec.P > MAX_PREDS:
        out.append(_err(
            "kernel-preds", loc,
            f"P={spec.P} > LR_MAX_PREDS={MAX_PREDS}: the row-sourced "
            f"kernel keeps one row cursor per predecessor in registers; "
            f"its launcher refuses the call"))
    if spec.E > MAX_DIRS:
        out.append(_err(
            "kernel-dirs", loc,
            f"{spec.E} comparisons > LE_MAX_DIRS={MAX_DIRS}: the kernel "
            f"passes the directions by value in a fixed array; its "
            f"launcher refuses the call"))
    if spec.Q and spec.entry != "rows":
        out.append(_err("kernel-window", loc,
                        "signed prefix columns on a mask-mode entry"))
    if spec.window <= 0:
        out.append(_err(
            "kernel-window", loc,
            f"window={spec.window}: every membership search would be "
            f"over an empty row"))
    if spec.width < 0 or spec.width > spec.window:
        out.append(_err(
            "kernel-window", loc,
            f"bucket width {spec.width} outside [0, window={spec.window}]: "
            f"a candidate row is read past the longest row the executor "
            f"sized for"))
    if spec.padded_len > INT32_MAX:
        out.append(_err(
            "kernel-int32-offset", loc,
            f"padded flat length {spec.padded_len} (flat_len="
            f"{spec.flat_len} + {flat_gather_pad()}) overflows int32: "
            f"CSR offsets wrap and the kernel reads the wrong rows"))
    if spec.window > 0 and spec.flat_len + spec.window > INT32_MAX:
        out.append(_err(
            "kernel-int32-offset", loc,
            f"furthest candidate read {spec.flat_len + spec.window} "
            f"(flat_len + window) overflows int32"))
    if spec.entry == "compact":
        if spec.capacity < 0 or spec.capacity + 1 > INT32_MAX:
            out.append(_err(
                "kernel-int32-offset", loc,
                f"capacity {spec.capacity}: parent/newcol hold C + 1 "
                f"int32 slots and row ids below C"))
        if spec.capacity == 0:
            out.append(Finding(
                WARNING, "kernel-window", loc,
                "compaction into a frontier of capacity 0: every pair "
                "is dropped"))
    return out


def abstract_eval_spec(spec: LevelExpandSpec) -> list[Finding]:
    """Run the entry's own input checks on `meta` tensors of this
    spec's shapes (nothing is allocated or launched): a refusal is a
    finding."""
    import torch

    from ..kernels import ops

    def t(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    B, P = spec.B, spec.P
    flat = t(spec.padded_len)
    starts, lens = t(P, B), t(P, B)
    extra = t(B, spec.E) if spec.E else None
    dirs = (0,) * spec.E
    try:
        if spec.entry == "rows":
            ops.validate_level_expand_rows(
                flat, t(B), t(B), flat, starts, lens, t(B), extra,
                t(B, spec.Q) if spec.Q else None, dirs=dirs,
                width=spec.width)
        elif spec.entry == "compact":
            slots = spec.capacity + 1
            ops.validate_level_expand_compact(
                flat, t(B), t(B), flat, starts, lens, t(B), extra, t(B),
                t(dtype=torch.int64), t(slots), t(slots), dirs=dirs,
                width=spec.width)
        else:
            ops.validate_level_expand(
                t(B, spec.width), flat, starts, lens, extra,
                t(B, spec.width, dtype=torch.bool), dirs=dirs)
    except (TypeError, ValueError) as e:
        return [_err("kernel-abstract-eval", spec.label,
                     f"the {spec.entry} entry refuses the call: "
                     f"{type(e).__name__}: {e}")]
    return []


def executor_specs(n: int, m: int, max_degree: int, cfg=None,
                   *, label: str = "graph") -> list[LevelExpandSpec]:
    """The call shapes `core.executor` generates on a card for a graph of
    this shape under `cfg`: per degree bucket, the mask levels'
    compaction, the last level's count, an IEP tail's signed count, and
    the reference-shaped gathered window."""
    from ..core.executor import SLICE_ENTRIES, ExecutorConfig

    cfg = cfg or ExecutorConfig()
    W = max(int(max_degree), 1)
    flat_len = 2 * int(m)
    buckets = cfg.degree_buckets
    if buckets is not None:
        buckets = tuple((min(int(w), W), float(f)) for (w, f) in buckets)
        if buckets[-1][0] < W:
            buckets = buckets + ((W, buckets[-1][1]),)
    else:
        buckets = ((W, 1.0),)
    specs = []
    for bi, (width, frac) in enumerate(buckets):
        cap = max(int(cfg.capacity * frac), 8)
        rows = min(cap, max(SLICE_ENTRIES // max(width, 1), 1))
        base = dict(B=rows, width=width, P=2, window=W, flat_len=flat_len)
        tag = f"{label}/bucket{bi}[w={width}]"
        specs.append(LevelExpandSpec(E=2, entry="compact",
                                     capacity=cfg.capacity,
                                     label=f"{tag}/mask", **base))
        specs.append(LevelExpandSpec(E=1, entry="rows",
                                     label=f"{tag}/count", **base))
        # IEP tail: the assigned prefix vertices ride along as negatively
        # weighted columns after the bucket's width
        specs.append(LevelExpandSpec(Q=4, entry="rows",
                                     label=f"{tag}/signed", **base))
        specs.append(LevelExpandSpec(E=2, entry="window",
                                     label=f"{tag}/window", **base))
    return specs


def check_graph_contract(graph_or_shape, cfg=None, *,
                         deep: bool = False) -> list[Finding]:
    """Prove K1's contract for a graph shape and executor config.

    `graph_or_shape` is a `GraphCSR` or an (n, m, max_degree) triple —
    the latter reasons about graphs too big to materialize.
    `deep=True` also runs each entry's checks on `meta` tensors of every
    generated call shape; the proofs alone are pure arithmetic."""
    from ..kernels.ops import flat_gather_pad

    if hasattr(graph_or_shape, "indptr"):
        n, m = graph_or_shape.n, graph_or_shape.m
        W = graph_or_shape.max_degree
        label = graph_or_shape.name or "graph"
    else:
        n, m, W = graph_or_shape
        label = f"shape(n={n},m={m},W={W})"
    out: list[Finding] = []
    if 2 * m + flat_gather_pad() > INT32_MAX:
        out.append(_err(
            "kernel-int32-offset", label,
            f"padded flat CSR length {2 * m + flat_gather_pad()} "
            f"overflows int32 indexing; the graph needs int64 offsets "
            f"the kernel does not implement"))
    if n > INT32_MAX:
        out.append(_err(
            "kernel-int32-offset", label,
            f"|V|={n} overflows int32 vertex ids"))
    for spec in executor_specs(n, m, W, cfg, label=label):
        found = check_spec(spec)
        out += found
        if deep and not any(f.severity == ERROR for f in found):
            out += abstract_eval_spec(spec)
    return out
