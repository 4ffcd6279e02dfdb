"""PyTorch vectorized pattern-matching executor (one device, or one
process per GPU with `ShardedMatcher`).

Port of the reference's `repro/core/executor.py`: GraphPi's nested-loop
DFS as level-synchronous frontier expansion.

 * a dense [capacity, depth] matrix of partial embeddings is expanded
   one schedule position at a time;
 * candidate generation gathers a fixed-width window from the flat CSR
   `indices` array at the (per-row minimum-degree) base predecessor;
 * ONE shared per-level admissibility core (`expand_core`) serves every
   path — bucketed and single-window expansion, the last-level popcount
   and the IEP-tail cardinalities.  On the kernel path the whole level
   (membership against all predecessors + restriction + injectivity
   masks, reduced to a popcount or to the compacted next frontier) runs
   in the CUDA kernel K1, which reads the candidates from the base's
   CSR row itself: `kernels/ops.level_expand_rows` for popcounts,
   `ops.level_expand_compact` for inner levels, which also writes the
   surviving (row, candidate) pairs behind the running offset; the
   portable path is a vectorized binary search over flat CSR segments
   plus torch masks;
 * compaction is a cumsum scatter (stream compaction; inside K1 on the
   kernel path);
 * labeled plans prune candidates at the gather (per-label CSR
   segments), identically on both paths;
 * the IEP tail is evaluated in closed form per surviving prefix.

Where the reference leans on JAX's out-of-range rules, the port is
explicit: gathers clamp their indices (`take(mode="clip")`), scatters
keep the reference's sentinel slot (`sel` sized cap+1, `parent` /
`newcol` / IEP cards sized C+1) and slice it off
(`.at[].set(mode="drop")`).  Everything runs eagerly on the device the
matcher was built for.  One departure from the reference's static
shapes: each bucket expands only its live rows (one host sync per
bucket reads how many), in slices of bounded size, so a level's work and
memory follow the frontier rather than the capacity.  That makes a large
capacity cheap, and the escalation ceiling is correspondingly higher
(`Matcher.MAX_CAPACITY`).  Counts, `needed` and the overflow logic are
the reference's; counts are int64 tensors, no x64 switch is needed.
`ShardedMatcher` keeps the reference's striped layout and whole-pass
doubling; its `needed` stays int64 (the reference's int32 would wrap
below the port's higher ceiling).
"""
from __future__ import annotations

import hashlib
import json
import math
import time
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..graph.csr import GraphCSR
from ..kernels import ops
from ..kernels.ref import bs_iters as _bs_iters
from ..kernels.ref import compact_pairs as _compact_pairs
from ..kernels.ref import gather_window as _gather_window
from ..kernels.ref import segment_member as _segment_member
from ..obs import get_tracer
from .pattern import clique
from .perf_model import GraphStats
from .plan import MatchingPlan, build_plan, plan_to_dict
from .restrictions import generate_restriction_sets

I32 = torch.int32
I64 = torch.int64
# Candidate entries expanded at once (rows × window width): bounds the
# memory of one level at escalated capacities (2**26 int32 ≈ 256 MiB).
SLICE_ENTRIES = 1 << 26


@dataclass(frozen=True)
class ExecutorConfig:
    capacity: int = 1 << 15          # frontier rows per level
    dynamic_base: bool = True        # per-row min-degree base predecessor
    # Fused level-expansion kernel K1 (the CUDA hot path).  False = the
    # portable path.  Which version of K1 runs is `ops.level_expand`'s
    # choice alone: the CUDA kernel for CUDA tensors, its plain version
    # for CPU tensors.
    use_kernel: bool = True
    # Degree-bucketed expansion: ((width, frac), ...) ascending widths;
    # rows whose base degree fits a narrower window are compacted into a
    # frac·capacity sub-frontier and gathered at that width.  None =
    # single max-degree window, internally the one-bucket layout
    # ((W, 1.0),) — both run the same expansion core.
    degree_buckets: tuple | None = None

    def fingerprint(self) -> str:
        """Stable string of the facets that shape a count program
        (capacity, base selection, kernel path, bucket layout)."""
        buckets = "none" if self.degree_buckets is None else ";".join(
            f"{int(w)}:{float(f):.6g}" for w, f in self.degree_buckets)
        return (f"cap={self.capacity},dyn={int(self.dynamic_base)},"
                f"kernel={int(self.use_kernel)},"
                f"buckets={buckets}")


def auto_buckets(graph, *, small: int = 128, mid: int = 1024,
                 stats: GraphStats | None = None):
    """Degree buckets from the graph's degree distribution (the
    reference's layouts, `executor.py:117-157`): the legacy layout sizes
    fractions ~4× above the empirical vertex-count shares; with `stats`
    they come from the perf model's predicted frontier occupancy.  Any
    layout counts exactly; the layout only moves capacity."""
    W = max(graph.max_degree, 1)
    if W <= small:
        return None
    deg = graph.degrees

    if stats is not None:
        from .perf_model import predicted_frontier_occupancy

        def frac(lo: int) -> float:
            return min(1.0, max(
                predicted_frontier_occupancy(stats, deg, lo), 1 / 64))
    else:
        n = max(len(deg), 1)

        def frac(lo: int) -> float:
            return min(1.0, max(4.0 * float((deg > lo).sum()) / n, 1 / 64))

    out = [(small, 1.0)]
    if W > mid:
        out.append((mid, frac(small)))
        out.append((W, frac(mid)))
    else:
        out.append((W, frac(small)))
    return tuple(out)


@dataclass
class CountResult:
    count: int
    overflowed: bool
    max_needed: int                  # max frontier rows needed at any level


@dataclass
class CountState:
    """Resumable progress of one chunked count (`Matcher.count_partial`).

    The outer vertex loop is a work stack of ``(start, end, capacity)``
    spans; a preempted count is exactly this stack plus the raw running
    totals.  `total` is the RAW embedding sum — the IEP divisor (and the
    naive-mode |Aut| division) apply once at completion."""

    spans: list                      # [(start, end, capacity)], LIFO
    chunk: int                       # resolved chunk width (span rebuilds)
    total: int = 0                   # raw sum, pre iep_divisor
    overflowed: bool = False
    max_needed: int = 0
    dispatches: int = 0              # count dispatches so far (all segments)


# --------------------------------------------------------------------------
# single-shard counting function (eager torch on the arrays' device)
# --------------------------------------------------------------------------
def _make_count_fn(plan: MatchingPlan, W: int, iters: int,
                   cfg: ExecutorConfig, *, device):
    """Returns count(indptr, degrees, flat, labs, v0, *,
    discard_overflow=False) -> (count, needed), both 0-d int64 tensors
    on `device`.  `labs` = (vlabels [n+1], lab_starts [n+1, L],
    lab_lens [n+1, L], lab_flat) for labeled plans, else None.

    `W` = candidate-window width (graph max degree).  `degrees` must be
    padded to [n+1] with 0 at index n (sentinel).

    `discard_overflow` says that the caller throws the count away when
    `needed` exceeds the capacity (a dispatch it will split or rerun at
    a larger capacity).  The last enumeration level's demand is known
    before that level expands a row, so `needed` is final then; if it
    overflows, the level's row slices (its gathers and K1 count calls)
    are skipped and `count` is None.  `needed` is exact either way; an
    IEP tail is never skipped.

    Each schedule level, and the IEP tail (`level="iep"`), runs in an
    `executor.level` span; a tracer with `sync` (`--trace-sync`) fences
    each with a device synchronize, so the span is the level's device
    time, and notes the level's `needed` and surviving `frontier`; the
    last enumeration level's span notes whether it was `skipped`.
    Every host read of a device value is a `device.sync` span, every K1
    call a `kernel.<entry>` span."""
    n = plan.n
    depth = plan.depth
    C = cfg.capacity
    use_kernel = cfg.use_kernel
    vlabels = plan.vlabels or (None,) * n
    dev = torch.device(device)

    buckets = cfg.degree_buckets
    if buckets is not None:
        buckets = tuple((min(int(w), W), float(f)) for (w, f) in buckets)
        if buckets[-1][0] < W:
            buckets = buckets + ((W, buckets[-1][1]),)
    else:
        buckets = ((W, 1.0),)

    arangeC = torch.arange(C, dtype=I32, device=dev)

    def window_source(flat, indptr, degrees, base, *, labs=None,
                      label=None):
        """The candidate row at `base` as (array, offsets, lengths): the
        CSR row, or its per-label segment for a labeled position."""
        if label is not None:
            _, lab_starts, lab_lens, lab_flat = labs
            return lab_flat, lab_starts[base, label], lab_lens[base, label]
        return flat, indptr[base], degrees[base]

    def gather_window(flat, indptr, degrees, base, width, *, labs=None,
                      label=None):
        """Candidate window at `base`.  Windows of the last rows may run
        past the array: indices clamp to its end, and `ok` masks those
        columns."""
        return _gather_window(*window_source(flat, indptr, degrees, base,
                                             labs=labs, label=label), width)

    def base_degrees(degrees, pv, *, labs=None, label=None):
        if label is not None:
            return labs[2][pv, label]
        return degrees[pv]

    def pick_base(emb, degrees, preds, *, labs=None, label=None):
        """(base vertex, its index among `preds`) per row."""
        pv = emb[:, list(preds)]                       # [C, P]
        if not cfg.dynamic_base or len(preds) == 1:
            return pv[:, -1], torch.full((pv.shape[0],), len(preds) - 1,
                                         dtype=I32, device=dev)
        dg = base_degrees(degrees, pv, labs=labs, label=label)
        sel = torch.argmin(dg, dim=1)                  # first minimum
        return (torch.take_along_dim(pv, sel[:, None], dim=1)[:, 0],
                sel.to(I32))

    def level_extras(i):
        """Restriction + injectivity comparisons at position i as
        ((emb column, dir), ...); dir ∈ {+1: >, -1: <, 0: !=}."""
        return tuple(plan.restr[i]) + tuple((j, 0) for j in plan.neqs[i])

    def k1_span(entry, mode, rows, preds, width):
        """The span `kernel.<entry>` of one K1 call, with its shapes.
        The caller opens it around the entry, so that a profiler range
        opened inside the entry stays the innermost around K1's
        launches and keeps their device time."""
        return get_tracer().span("kernel." + entry, mode=mode, rows=rows,
                                 preds=preds, width=width)

    def expand_core(emb, base, own, preds, extras, indptr, degrees, flat,
                    width, *, want_counts=False, labs=None, label=None):
        """THE per-level admissibility core over rows that are all live
        (the caller expands only the selected rows).  Returns
        (cand, mask), or per-row int32 counts when `want_counts`.  `own`
        = base's index among `preds`: the kernel reads the candidates
        from base's row and never searches that row.  On the kernel path
        inner levels go to `expand_compact` instead, which never forms
        (cand, mask)."""
        if use_kernel and len(preds) > 1 and want_counts:
            (starts, lens), kw = kernel_args(emb, preds, extras, indptr,
                                             degrees)
            with k1_span("level_expand_rows", "count", emb.shape[0],
                         len(preds), width):
                return ops.level_expand_rows(
                    *window_source(flat, indptr, degrees, base, labs=labs,
                                   label=label),
                    flat, starts, lens, own, width=width, window=W, **kw)
        cand, mask = gather_window(flat, indptr, degrees, base, width,
                                   labs=labs, label=label)
        if len(preds) > 1:
            for p in preds:
                u = emb[:, p]
                lo = indptr[u][:, None]
                hi = lo + degrees[u][:, None]
                mask &= _segment_member(flat, lo, hi, cand, iters)
        for (col, d) in extras:
            ev = emb[:, col][:, None]
            if d > 0:
                mask &= cand > ev
            elif d < 0:
                mask &= cand < ev
            else:
                mask &= cand != ev
        if want_counts:
            return mask.sum(dim=1, dtype=I32)
        return cand, mask

    def kernel_args(emb, preds, extras, indptr, degrees):
        """K1's predecessor rows (starts, lens: [P, B]) and the prefix
        values of the comparisons, as keywords `extra` and `dirs`."""
        us = emb[:, list(preds)].T.contiguous()                   # [P, B]
        ex = emb[:, [c for c, _ in extras]] if extras else None
        return (indptr[us], degrees[us]), dict(
            extra=ex, dirs=tuple(d for _, d in extras))

    def expand_compact(emb, base, own, idx, preds, extras, indptr, degrees,
                       flat, width, offset, parent, newcol, *, labs=None,
                       label=None):
        """An inner level's expansion and stream compaction over the
        frontier rows `idx`: the surviving (row, candidate) pairs go to
        `parent` / `newcol` behind `offset`, which advances by their
        total; pairs past capacity are dropped (the sentinel slot).  On
        the kernel path (two or more predecessors) that is one call of
        K1's mask-and-compact entry; else `expand_core`'s mask, then
        the reference's cumsum scatter."""
        if use_kernel and len(preds) > 1:
            (starts, lens), kw = kernel_args(emb, preds, extras, indptr,
                                             degrees)
            with k1_span("level_expand_compact", "mask", idx.shape[0],
                         len(preds), width):
                ops.level_expand_compact(
                    *window_source(flat, indptr, degrees, base, labs=labs,
                                   label=label),
                    flat, starts, lens, own, rows=idx, offset=offset,
                    parent=parent, newcol=newcol, width=width, window=W,
                    **kw)
            return
        cand, mask = expand_core(emb, base, None, preds, extras, indptr,
                                 degrees, flat, width, labs=labs,
                                 label=label)
        _compact_pairs(mask, cand, idx, offset, parent, newcol)

    def select_rows(rowmask, cap):
        """Compact indices of rows where rowmask → (sel_idx [cap] with C
        as the drop sentinel, sub_total)."""
        pos = torch.cumsum(rowmask, 0, dtype=I32) - 1
        total = pos[-1] + 1
        out_idx = torch.where(rowmask, pos.clamp(max=cap), cap)
        sel = torch.full((cap + 1,), C, dtype=I32, device=dev)
        sel[out_idx] = arangeC
        return sel[:cap], total

    def live_rows(sub_total, cap, level, bucket, needed=None):
        """The live row count of a compacted sub-frontier (the
        reference's `sub_valid` prefix, min(sub_total, cap) rows), read
        on the host: a sync.  With `needed`, the same read also returns
        its value, else None."""
        with get_tracer().span("device.sync", site="slice_rows",
                               level=level, bucket=bucket) as sp:
            if needed is None:
                total, need = int(sub_total), None
            else:
                total, need = torch.stack(
                    (sub_total.to(I64), needed)).tolist()
            rows = min(total, cap)
            sp.set(rows=rows)
        return rows, need

    def row_slices(sel_idx, rows, width):
        """The first `rows` rows of a compacted sub-frontier in slices of
        at most SLICE_ENTRIES candidates: only live rows are ever
        expanded, so the work and memory of a level follow the frontier,
        not the capacity."""
        step = max(SLICE_ENTRIES // max(width, 1), 1)
        for r0 in range(0, rows, step):
            yield sel_idx[r0:min(rows, r0 + step)]

    def scaled_need(sub_total, cap):
        """Escalation units: sub_total scaled to full-capacity terms so
        the driver's capacity doubling also doubles every bucket."""
        return (sub_total.to(I64) * C + cap - 1) // cap

    def bucket_ranges():
        lo = 0
        for bi, (w, f) in enumerate(buckets):
            cap = max(int(C * f), 8)
            yield bi, w, cap, lo, bi == len(buckets) - 1
            lo = w

    def expand_level(i, emb, valid, needed, indptr, degrees, flat,
                     labs=None, *, discard_overflow=False):
        """One level over the bucket layout.  Returns (new_emb,
        new_valid, needed) — or, at the last enumeration level, (count,
        None, needed).

        Every bucket's rows are selected, and its demand taken into
        `needed`, before any bucket is expanded.  At the last enumeration
        level `needed` is then final, and the first bucket's row count
        is read together with it.  If it exceeds C and the caller
        discards an overflowing count (`discard_overflow`), no bucket's
        rows are expanded and count is None: the K1 calls only feed the
        count, so `needed` is the same as if they had run."""
        preds = plan.preds[i]
        extras = level_extras(i)
        label = vlabels[i]
        base_all, own_all = pick_base(emb, degrees, preds, labs=labs,
                                      label=label)
        db = base_degrees(degrees, base_all, labs=labs, label=label)
        last_enum = (plan.iep is None) and (i == n - 1)
        parent = torch.zeros((C + 1,), dtype=I32, device=dev)
        newcol = torch.zeros((C + 1,), dtype=I32, device=dev)
        offset = torch.zeros((), dtype=I64, device=dev)
        total_cnt = torch.zeros((), dtype=I64, device=dev)
        picked = []
        for bi, width, cap, lo, is_last in bucket_ranges():
            rowmask = valid & (db > lo)
            if not is_last:
                rowmask &= db <= width
            sel_idx, sub_total = select_rows(rowmask, cap)
            needed = torch.maximum(needed, scaled_need(sub_total, cap))
            picked.append((bi, width, cap, sel_idx, sub_total))
        read_need = last_enum and discard_overflow
        skip = False
        for bi, width, cap, sel_idx, sub_total in picked:
            rows, need = live_rows(sub_total, cap, i, bi,
                                   needed if read_need and bi == 0 else None)
            if need is not None:
                skip = need > C
            if skip:
                continue
            for idx in row_slices(sel_idx, rows, width):
                sub_emb = emb[idx][:, :i]
                sub_base = base_all[idx]
                if last_enum:
                    cnts = expand_core(
                        sub_emb, sub_base, own_all[idx], preds, extras,
                        indptr, degrees, flat, width, want_counts=True,
                        labs=labs, label=label)
                    total_cnt += cnts.sum(dtype=I64)
                    continue
                expand_compact(sub_emb, sub_base, own_all[idx], idx, preds,
                               extras, indptr, degrees, flat, width, offset,
                               parent, newcol, labs=labs, label=label)
        if last_enum:
            return (None if skip else total_cnt), None, needed
        new_emb = torch.cat(
            [emb[parent[:C]][:, :i], newcol[:C, None]], dim=1)
        new_valid = arangeC < offset
        needed = torch.maximum(needed, offset)
        return new_emb, new_valid, needed

    def iep_card_fused(sub_emb, sub_base, sub_own, U, indptr, degrees, flat,
                       width):
        """One IEP-term cardinality — |window ∩ (∩_q N(v_q))| minus the
        prefix-vertex corrections — in ONE kernel launch: the assigned
        prefix vertices ride along as negatively-weighted columns
        (`neg`), so the signed popcount is raw − corr."""
        us = sub_emb[:, list(U)].T.contiguous()                   # [P, B]
        with k1_span("level_expand_rows", "signed", sub_emb.shape[0],
                     len(U), width):
            signed = ops.level_expand_rows(
                *window_source(flat, indptr, degrees, sub_base), flat,
                indptr[us], degrees[us], sub_own, None, sub_emb,
                width=width, window=W)
        return signed.to(I64)

    def iep_value(emb, valid, indptr, degrees, flat):
        """Per-row IEP count over the folded tail (int64), with bucketed
        union-window gathers through the shared expansion core."""
        iep = plan.iep
        cards = []
        needed_extra = torch.zeros((), dtype=I64, device=dev)
        for U in iep.unions:
            base, own = pick_base(emb, degrees, U)
            db = degrees[base]
            card = torch.zeros((C,), dtype=I64, device=dev)
            for bi, width, cap, lo, is_last in bucket_ranges():
                rowmask = valid & (db > lo)
                if not is_last:
                    rowmask &= db <= width
                sel_idx, sub_total = select_rows(rowmask, cap)
                needed_extra = torch.maximum(needed_extra,
                                             scaled_need(sub_total, cap))
                rows, _ = live_rows(sub_total, cap, "iep", bi)
                for idx in row_slices(sel_idx, rows, width):
                    sub_emb = emb[idx]
                    sub_base = base[idx]
                    if use_kernel:
                        val = iep_card_fused(sub_emb, sub_base, own[idx], U,
                                             indptr, degrees, flat, width)
                    else:
                        val = expand_core(
                            sub_emb, sub_base, None, U, (), indptr, degrees,
                            flat, width, want_counts=True).to(I64)
                        # subtract already-assigned prefix vertices inside
                        # the intersection (injectivity w.r.t. outer loops)
                        for j in range(depth):
                            vj = sub_emb[:, j]
                            inside = torch.ones_like(vj, dtype=torch.bool)
                            for q in U:
                                u = sub_emb[:, q]
                                inside &= _segment_member(
                                    flat, indptr[u], indptr[u] + degrees[u],
                                    vj, iters)
                            val -= inside.to(I64)
                    card.index_add_(0, idx, val)
            cards.append(card)
        val = torch.zeros((C,), dtype=I64, device=dev)
        for coeff, idxs in iep.terms:
            term = torch.full((C,), coeff, dtype=I64, device=dev)
            for u in idxs:
                term = term * cards[u]
            val = val + term
        return torch.where(valid, val, 0), needed_extra

    def fence(sp, needed, new_valid=None):
        """`--trace-sync`: wait for the level's device work, then note
        its capacity demand and surviving frontier on its span."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sp.set(needed=int(needed))
        if new_valid is not None:
            sp.set(frontier=int(new_valid.sum()))

    def count(indptr, degrees, flat, labs, v0, *, discard_overflow=False):
        tr = get_tracer()
        fenced = tr.enabled and tr.sync
        emb = v0[:, None].to(I32)                          # [T, 1]
        valid = v0 < (indptr.shape[0] - 1)
        if vlabels[0] is not None:
            # v0 is padded with the sentinel n, and the device vlabels
            # array carries -1 there, so sentinels never match a label
            valid &= labs[0][v0] == vlabels[0]
        T = emb.shape[0]
        if T < C:
            emb = torch.nn.functional.pad(emb, (0, 0, 0, C - T))
            valid = torch.nn.functional.pad(valid, (0, C - T))
        needed = torch.tensor(T, dtype=I64, device=dev)
        for i in range(1, depth):
            with tr.span("executor.level", level=i) as sp:
                out, new_valid, needed = expand_level(
                    i, emb, valid, needed, indptr, degrees, flat, labs,
                    discard_overflow=discard_overflow)
                if new_valid is None:
                    sp.set(skipped=out is None)
                if fenced:
                    fence(sp, needed, new_valid)
            if new_valid is None:          # last enumeration level
                return out, needed
            emb, valid = out, new_valid
        if plan.iep is None:
            # depth-1 == 0: single-vertex pattern — count valid v0 rows
            return valid.sum(dtype=I64), needed
        with tr.span("executor.level", level="iep") as sp:
            vals, need2 = iep_value(emb, valid, indptr, degrees, flat)
            if fenced:
                fence(sp, need2)
        return vals.sum(), torch.maximum(needed, need2)

    return count


# --------------------------------------------------------------------------
# public host-side drivers
# --------------------------------------------------------------------------
class DeviceGraph(NamedTuple):
    """Resident device tensors for one graph: (indptr, padded degrees,
    flat) plus `labs` = (vlabels, lab_starts, lab_lens, lab_flat) for
    labeled graphs, or None."""

    indptr: torch.Tensor
    degrees: torch.Tensor
    flat: torch.Tensor
    labs: tuple | None = None


def device_graph(graph: GraphCSR, device="cuda") -> DeviceGraph:
    """Upload one graph to `device` (indptr, padded degrees, flat).

    As in the reference: degrees get a 0 at index n (the frontier's
    sentinel root), the flat indices array gets flat_gather_pad()
    never-matching sentinels, and labeled graphs upload the per-label
    CSR view with a -1 label / all-empty row at index n."""
    dev = resolve_device(device)

    def up(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                               device=dev)

    degrees = np.concatenate([graph.degrees, np.zeros(1, dtype=np.int32)])
    flat = np.concatenate([
        graph.indices,
        np.full(ops.flat_gather_pad(), ops.NBR_PAD, dtype=np.int32)])
    labs = None
    if graph.labels is not None:
        lv = graph.label_view
        L = graph.n_labels
        labs = (
            up(np.concatenate([graph.labels, np.full(1, -1, np.int32)])),
            up(np.concatenate([lv.starts, np.zeros((1, L), np.int32)])),
            up(np.concatenate([lv.lens, np.zeros((1, L), np.int32)])),
            up(lv.flat),
        )
    return DeviceGraph(up(graph.indptr), up(degrees), up(flat), labs)


def _leaves(arrays: DeviceGraph) -> list:
    return [*arrays[:3], *(arrays.labs or ())]


class Matcher:
    """Reusable single-device matcher: build once, count many times.

    ``warmup()`` builds the kernel (first use compiles it) and runs one
    sentinel frontier, so neither pollutes a timed count."""

    # Escalation ceiling.  The reference stops at 2**22 rows because its
    # static shapes cost capacity × window per level; here a capacity row
    # costs a few dozen bytes (the frontier matrix and the compaction
    # buffers), so 2**28 rows take tens of GiB at most of an 80 GB card —
    # enough for the single-root frontiers of P1 on wiki-vote-syn (2.1e8
    # rows under the graphzero plan), which the reference can only flag
    # as overflowed.
    MAX_CAPACITY = 1 << 28

    def __init__(self, graph: GraphCSR, plan: MatchingPlan,
                 cfg: ExecutorConfig | None = None, *, arrays=None,
                 device="cuda"):
        self.graph = graph
        self.plan = plan
        self.cfg = cfg or ExecutorConfig()
        self.device = resolve_device(device)
        self._W = max(graph.max_degree, 1)
        self._fns: dict[int, object] = {}     # capacity -> count fn
        if arrays is None:
            arrays = device_graph(graph, self.device)
        if arrays.indptr.device != self.device:
            raise ValueError(f"arrays on {arrays.indptr.device}, matcher "
                             f"on {self.device}")
        self._arrays = arrays
        self._labeled = plan.vlabels is not None
        if self._labeled and self._arrays.labs is None:
            raise ValueError(
                f"labeled pattern {plan.pattern.name!r} cannot run against "
                f"unlabeled graph {graph.name!r}")
        self._capacity = self.cfg.capacity    # sticky escalated capacity

    def _call_args(self):
        a = self._arrays
        return (a.indptr, a.degrees, a.flat, a.labs)

    def _fn(self, capacity: int):
        if capacity not in self._fns:
            self._fns[capacity] = _make_count_fn(
                self.plan, self._W, _bs_iters(self._W),
                replace(self.cfg, capacity=capacity), device=self.device)
        return self._fns[capacity]

    def _v0(self, s: int, e: int, width: int) -> torch.Tensor:
        v0 = torch.full((max(width, e - s),), self.graph.n, dtype=I32,
                        device=self.device)
        v0[: e - s] = torch.arange(s, e, dtype=I32, device=self.device)
        return v0

    def warmup(self, *, chunk: int | None = None) -> None:
        """Build the kernel and run one all-sentinel frontier of the
        width :meth:`count` will use.  The sentinel frontier has no live
        rows, so it launches nothing: the kernel is loaded explicitly."""
        if self._arrays is None:
            raise RuntimeError("matcher was released (evicted from cache)")
        if self.cfg.use_kernel:
            ops.prepare(self.device)
        width = min(chunk or self.cfg.capacity, self.cfg.capacity)
        v0 = torch.full((width,), self.graph.n, dtype=I32, device=self.device)
        _, needed = self._fn(self.cfg.capacity)(*self._call_args(), v0)
        with get_tracer().span("device.sync", site="warmup"):
            int(needed)

    def release(self) -> None:
        """Drop every count function and device-tensor reference (the
        resident graph shared via ``arrays=`` stays alive at its owner).
        The matcher is unusable afterwards."""
        self._fns.clear()
        self._arrays = None

    def rebind(self, arrays, *, graph=None) -> None:
        """Swap the resident device tensors for same-shaped replacements.
        Any shape, dtype or device difference raises ValueError; `graph`
        additionally swaps the host-side view and must keep the gather
        window and the vertex count."""
        if self._arrays is None:
            raise RuntimeError("matcher was released (evicted from cache)")
        arrays = DeviceGraph(*arrays)
        old, new = _leaves(self._arrays), _leaves(arrays)
        if (len(old) != len(new)
                or any(tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype
                       or a.device != b.device
                       for a, b in zip(old, new))):
            raise ValueError(
                "rebind needs identical array shapes/dtypes; the graph "
                "outgrew its fixed layout — rebuild the matcher")
        if graph is not None:
            if max(graph.max_degree, 1) != self._W:
                raise ValueError(
                    f"rebind window {max(graph.max_degree, 1)} != compiled "
                    f"window {self._W}")
            if graph.n != self.graph.n:
                raise ValueError(
                    f"rebind vertex count {graph.n} != {self.graph.n}")
            self.graph = graph
        self._arrays = arrays

    def count(self, *, chunk: int | None = None) -> CountResult:
        """Chunked outer loop; a chunk that overflows capacity is bisected
        and retried.  A single root that still overflows escalates to a
        doubled capacity so the count stays exact.

        Each dispatch's span notes what it came to (`outcome`):
        `counted`, `split` (bisected), `escalated` (re-queued at double
        capacity) or `overflowed` (a single root at MAX_CAPACITY, counted
        and flagged); the count's span notes the `discarded` ones, split
        and escalated, whose work yielded no count."""
        _, out = self.count_partial(chunk=chunk)
        return out

    def count_partial(self, state: CountState | None = None, *,
                      chunk: int | None = None,
                      max_dispatches: int | None = None,
                      ) -> tuple[CountState, CountResult | None]:
        """Run the chunked outer loop for up to `max_dispatches`
        dispatches, then yield ``(state, result)``; `result` is None
        while spans remain — pass `state` back in to resume exactly where
        the loop stopped (the final count is bit-identical to an
        uninterrupted :meth:`count`).

        A dispatch that overflows its capacity is split or escalated and
        its count thrown away, but for a single root at MAX_CAPACITY,
        which is counted and flagged.  Every other dispatch lets the
        count function skip its last level's row slices once its
        `needed` is known to overflow (`discard_overflow`): `needed`, and
        with it the outcome, is the same; the count's span notes the
        dispatches whose tail was skipped (`tail_skipped`)."""
        if self._arrays is None:
            raise RuntimeError("matcher was released (evicted from cache)")
        graph, cfg = self.graph, self.cfg
        call_args = self._call_args()
        tr = get_tracer()
        trace_sync = tr.enabled and tr.sync
        if state is None:
            chunk = min(chunk or cfg.capacity, cfg.capacity)
            cap0 = self._capacity
            state = CountState(
                spans=[(s, min(s + chunk, graph.n), cap0)
                       for s in range(0, graph.n, chunk)],
                chunk=chunk,
            )
        chunk = state.chunk
        budget = None if max_dispatches is None else max(int(max_dispatches),
                                                         1)
        with tr.span(
                "executor.count", depth=self.plan.depth,
                buckets=cfg.fingerprint(), sync=trace_sync,
                resumed=state.dispatches > 0) as csp:
            spans = state.spans
            segment = discarded = skipped = 0
            while spans and (budget is None or segment < budget):
                s, e, cap = spans.pop()
                self._capacity = max(self._capacity, cap)
                width = min(chunk, cap)
                with tr.span("executor.dispatch", v0_start=s, v0_end=e,
                             capacity=cap, frontier=e - s) as dsp:
                    # only a single root at the ceiling keeps the
                    # count of an overflow
                    keep = e - s == 1 and cap >= self.MAX_CAPACITY
                    cnt, needed = self._fn(cap)(
                        *call_args, self._v0(s, e, width),
                        discard_overflow=not keep)
                    skipped += cnt is None
                    # int() waits for the device, so the dispatch span
                    # covers real compute time
                    with tr.span("device.sync", site="dispatch_needed"):
                        needed = int(needed)
                    if needed <= cap:
                        outcome = "counted"
                    elif e - s > 1:
                        outcome = "split"
                        mid = (s + e) // 2
                        spans += [(s, mid, cap), (mid, e, cap)]
                    elif cap < self.MAX_CAPACITY:
                        outcome = "escalated"
                        spans.append((s, e, cap * 2))
                    else:
                        outcome = "overflowed"  # cannot split/grow further
                        state.overflowed = True
                    if outcome in ("counted", "overflowed"):
                        with tr.span("device.sync", site="dispatch_count"):
                            state.total += int(cnt)
                    else:
                        discarded += 1
                    dsp.set(needed=needed, outcome=outcome)
                segment += 1
                state.dispatches += 1
                state.max_needed = max(state.max_needed, needed)
            csp.set(dispatches=segment, discarded=discarded,
                    tail_skipped=skipped, max_needed=state.max_needed,
                    preempted=bool(spans))
        if spans:
            return state, None
        return state, CountResult(count=state.total // self.plan.iep_divisor,
                                  overflowed=state.overflowed,
                                  max_needed=state.max_needed)


def count_embeddings(
    graph: GraphCSR,
    plan: MatchingPlan,
    cfg: ExecutorConfig | None = None,
    *,
    chunk: int | None = None,
    device="cuda",
) -> CountResult:
    """One-shot convenience wrapper around :class:`Matcher`."""
    return Matcher(graph, plan, cfg, device=device).count(chunk=chunk)


class ShardedMatcher:
    """Reusable multi-GPU matcher: one process per GPU, count many times.

    The reference's `ShardedMatcher` (`repro/core/executor.py:869-1024`)
    for SPMD ranks under `torch.distributed`.  Rank d of W takes the
    outer-loop roots v0 ∈ {d, d+W, 2W+d, ...} (fine-grained striping:
    with the datasets' degree-descending relabeling it spreads the
    power-law head over the ranks), scans its stripe in fixed-size
    chunks through the single-device count function — K1 on the rank's
    card — with the int64 total and the frontier demand kept on the
    device, and reduces both once per pass (one all_reduce SUM, one
    MAX).  If any chunk of any rank overflowed capacity, every rank
    reruns the whole pass at a doubled capacity (the straggler-free
    analogue of the single-device bisection); the escalated capacity is
    sticky, so a repeat count is one pass.

    A mesh runs one program on all its devices; ranks are not bound to.
    So the constructor all-gathers a digest of the plan, the graph
    fingerprint, the executor facets and the stripe layout, and raises
    on every rank if any rank differs: a rank counting another plan
    would make the sum wrong without a sign.  Construction, `warmup` and
    `count` are collectives: every rank of `group` calls them in the
    same order.
    """

    def __init__(self, graph: GraphCSR, plan: MatchingPlan, group, *,
                 cfg: ExecutorConfig | None = None, chunk: int | None = None,
                 arrays=None, device="cuda"):
        self.graph = graph
        self.plan = plan
        self.group = group
        self.cfg = cfg or ExecutorConfig()
        self.device = resolve_device(device)
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self._W = max(graph.max_degree, 1)
        if arrays is None:
            arrays = device_graph(graph, self.device)
        if arrays.indptr.device != self.device:
            raise ValueError(f"arrays on {arrays.indptr.device}, matcher "
                             f"on {self.device}")
        self._arrays = arrays
        if plan.vlabels is not None and arrays.labs is None:
            raise ValueError(
                f"labeled pattern {plan.pattern.name!r} cannot run against "
                f"unlabeled graph {graph.name!r}")
        self.chunk = chunk or max(64, self.cfg.capacity // 16)
        per = math.ceil(graph.n / self.world)
        per = math.ceil(per / self.chunk) * self.chunk  # chunk multiple
        self._per = per
        # column-major: rank d owns d, d+W, 2W+d, ... (sentinel roots n)
        v0 = np.full(self.world * per, graph.n, dtype=np.int32)
        v0[: graph.n] = np.arange(graph.n, dtype=np.int32)
        stripe = v0.reshape(per, self.world).T[self.rank]
        self._v0 = torch.as_tensor(np.ascontiguousarray(stripe),
                                   device=self.device)
        self._fns: dict[int, object] = {}     # capacity -> count fn
        self._capacity = self.cfg.capacity    # sticky escalated capacity
        self.passes = 0                       # count passes so far
        self.local_seconds = 0.0              # this rank's seconds in them
        self._check_same_program()

    def _check_same_program(self) -> None:
        h = hashlib.sha256(json.dumps(plan_to_dict(self.plan),
                                      sort_keys=True).encode())
        for part in (self.graph.fingerprint, self.cfg.fingerprint(),
                     f"n={self.graph.n},chunk={self.chunk},per={self._per}"):
            h.update(b"\0" + part.encode())
        digests = [None] * self.world
        dist.all_gather_object(digests, h.hexdigest(), group=self.group)
        differ = [r for r, d in enumerate(digests) if d != digests[0]]
        if differ:
            raise RuntimeError(
                f"ranks {differ} hold another plan, graph, executor "
                f"config or stripe layout than rank 0: a sharded count "
                f"needs one program on every rank")

    def _fn(self, capacity: int):
        if capacity not in self._fns:
            self._fns[capacity] = _make_count_fn(
                self.plan, self._W, _bs_iters(self._W),
                replace(self.cfg, capacity=capacity), device=self.device)
        return self._fns[capacity]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pass(self, capacity: int, v0: torch.Tensor, *,
              discard_overflow: bool = False):
        """This rank's chunks at `capacity`, then the reduction over the
        ranks: (raw total, max needed) as 0-d int64 tensors, this rank's
        seconds before the reduction (its share of the pass: the ranks'
        spread of it is the stripes' balance) and its chunks whose last
        level was skipped.

        With `discard_overflow` (a pass below MAX_CAPACITY: one chunk
        over capacity reruns the whole pass), a chunk whose `needed`
        overflows skips its last level's row slices and adds nothing to
        the total, which the rerun replaces; its `needed`, and so the
        pass's maximum, is exact."""
        fn = self._fn(capacity)
        a = self._arrays
        tot = torch.zeros((), dtype=I64, device=self.device)
        mx = torch.zeros((), dtype=I64, device=self.device)
        skipped = 0
        t0 = time.perf_counter()
        for c0 in range(0, self._per, self.chunk):
            cnt, needed = fn(a.indptr, a.degrees, a.flat, a.labs,
                             v0[c0:c0 + self.chunk],
                             discard_overflow=discard_overflow)
            if cnt is None:
                skipped += 1
            else:
                tot += cnt
            mx = torch.maximum(mx, needed)
        self._sync()
        local = time.perf_counter() - t0
        dist.all_reduce(tot, op=dist.ReduceOp.SUM, group=self.group)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=self.group)
        return tot, mx, local, skipped

    def warmup(self) -> None:
        """Build the kernel and run one pass over an all-sentinel stripe
        (no live rows, so nothing is counted), collectives included."""
        if self._arrays is None:
            raise RuntimeError("matcher was released (evicted from cache)")
        if self.cfg.use_kernel:
            ops.prepare(self.device)
        _, needed, _, _ = self._pass(
            self.cfg.capacity, torch.full_like(self._v0, self.graph.n))
        with get_tracer().span("device.sync", site="warmup"):
            int(needed)

    def release(self) -> None:
        """Drop every count function and device-tensor reference,
        the stripe this matcher owns included.  The matcher is unusable
        afterwards."""
        self._fns.clear()
        self._arrays = None
        self._v0 = None

    def rebind(self, arrays, *, graph=None) -> None:
        """As :meth:`Matcher.rebind`: the stripe depends only on `n`,
        which an overlay epoch keeps, so the count functions replay
        as they are."""
        if self._arrays is None:
            raise RuntimeError("matcher was released (evicted from cache)")
        arrays = DeviceGraph(*arrays)
        old, new = _leaves(self._arrays), _leaves(arrays)
        if (len(old) != len(new)
                or any(tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype
                       or a.device != b.device
                       for a, b in zip(old, new))):
            raise ValueError(
                "rebind needs identical array shapes/dtypes; the graph "
                "outgrew its fixed layout — rebuild the matcher")
        if graph is not None:
            if max(graph.max_degree, 1) != self._W:
                raise ValueError(
                    f"rebind window {max(graph.max_degree, 1)} != compiled "
                    f"window {self._W}")
            if graph.n != self.graph.n:
                raise ValueError(
                    f"rebind vertex count {graph.n} != {self.graph.n}")
            self.graph = graph
        self._arrays = arrays

    def count(self) -> CountResult:
        """Passes until one fits its capacity; each pass's span notes
        its `outcome` as `Matcher.count`'s dispatches do: `escalated`
        (rerun at a doubled capacity, so discarded), `counted` or
        `overflowed` (at MAX_CAPACITY, counted and flagged).  A pass
        below MAX_CAPACITY skips the last level of its overflowing
        chunks (`_pass`); the pass's span and the count's note this
        rank's chunks so skipped (`tail_skipped`)."""
        if self._arrays is None:
            raise RuntimeError("matcher was released (evicted from cache)")
        tr = get_tracer()
        # start from the last sufficient capacity, so a repeat skips the
        # undersized passes
        capacity = self._capacity
        discarded = tail_skipped = 0
        with tr.span("executor.count", depth=self.plan.depth,
                     sharded=True, chunk=self.chunk) as csp:
            while True:
                with tr.span("executor.dispatch", capacity=capacity,
                             frontier=self.world * self._per) as dsp:
                    cnt, needed, local, skipped = self._pass(
                        capacity, self._v0,
                        discard_overflow=capacity < Matcher.MAX_CAPACITY)
                    tail_skipped += skipped
                    with tr.span("device.sync", site="dispatch_needed"):
                        needed = int(needed)
                    if needed <= capacity:
                        outcome = "counted"
                    elif capacity >= Matcher.MAX_CAPACITY:
                        outcome = "overflowed"
                    else:
                        outcome = "escalated"
                    if outcome != "escalated":
                        with tr.span("device.sync", site="dispatch_count"):
                            total = int(cnt)
                    dsp.set(needed=needed, local_seconds=local,
                            outcome=outcome, tail_skipped=skipped)
                self.passes += 1
                self.local_seconds += local
                if outcome != "escalated":
                    break
                discarded += 1
                while capacity < min(needed, Matcher.MAX_CAPACITY):
                    capacity *= 2
            csp.set(max_needed=needed, capacity=capacity,
                    discarded=discarded, tail_skipped=tail_skipped)
        self._capacity = capacity
        return CountResult(count=total // self.plan.iep_divisor,
                           overflowed=needed > capacity, max_needed=needed)


def count_embeddings_sharded(
    graph: GraphCSR,
    plan: MatchingPlan,
    group,
    *,
    cfg: ExecutorConfig | None = None,
    chunk: int | None = None,
    device="cuda",
) -> CountResult:
    """One-shot convenience wrapper around :class:`ShardedMatcher` (a
    collective: every rank of `group` calls it)."""
    return ShardedMatcher(graph, plan, group, cfg=cfg, chunk=chunk,
                          device=device).count()


# --------------------------------------------------------------------------
# graph statistics (bootstraps the performance model with the executor)
# --------------------------------------------------------------------------
def triangle_plan() -> MatchingPlan:
    tri = clique(3)
    rs = generate_restriction_sets(tri, max_sets=1)[0]
    return build_plan(tri, (0, 1, 2), rs)


def compute_stats(
    graph: GraphCSR, cfg: ExecutorConfig | None = None, *, device="cuda",
    arrays=None,
) -> GraphStats:
    """|V|, |E| and exact triangle count (counted by the system itself)."""
    tri = Matcher(graph, triangle_plan(), cfg, arrays=arrays,
                  device=device).count()
    return GraphStats(
        n_vertices=graph.n, n_edges=graph.m, tri_cnt=tri.count
    )
