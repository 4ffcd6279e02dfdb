"""PyTorch vectorized pattern-matching executor (single device).

Port of the reference's `repro/core/executor.py:1-866, 1042-1058`:
GraphPi's nested-loop DFS as level-synchronous frontier expansion.

 * a dense [capacity, depth] matrix of partial embeddings is expanded
   one schedule position at a time;
 * candidate generation gathers a fixed-width window from the flat CSR
   `indices` array at the (per-row minimum-degree) base predecessor;
 * ONE shared per-level admissibility core (`expand_core`) serves every
   path — bucketed and single-window expansion, the last-level popcount
   and the IEP-tail cardinalities.  On the kernel path the whole level
   (membership against all predecessors + restriction + injectivity
   masks, reduced to a mask or a popcount) is one launch of the CUDA
   kernel K1 (`kernels/ops.level_expand`); the portable path is a
   vectorized binary search over flat CSR segments plus torch masks;
 * compaction is a cumsum scatter (stream compaction);
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
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..graph.csr import GraphCSR
from ..kernels import ops
from ..kernels.ref import bs_iters as _bs_iters
from ..kernels.ref import segment_member as _segment_member
from ..obs import get_tracer
from .pattern import clique
from .perf_model import GraphStats
from .plan import MatchingPlan, build_plan
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
                   cfg: ExecutorConfig, *, device, level_cb=None):
    """Returns count(indptr, degrees, flat, labs, v0) -> (count, needed),
    both 0-d int64 tensors on `device`.  `labs` = (vlabels [n+1],
    lab_starts [n+1, L], lab_lens [n+1, L], lab_flat) for labeled plans,
    else None.

    `W` = candidate-window width (graph max degree).  `degrees` must be
    padded to [n+1] with 0 at index n (sentinel).

    `level_cb` hooks per-level observability: every schedule level runs
    as ``level_cb(i, thunk)`` (`i="iep"` for the IEP tail); the Matcher
    passes one only on the `--trace-sync` path."""
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

    def gather_window(flat, indptr, degrees, base, width, *, labs=None,
                      label=None):
        """Candidate window at `base` (per-label segment for a labeled
        position).  Windows of the last rows may run past the array:
        indices clamp to its end, and `ok` masks those columns."""
        cols = torch.arange(width, dtype=I32, device=dev)
        if label is not None:
            _, lab_starts, lab_lens, lab_flat = labs
            start = lab_starts[base, label]
            src, length = lab_flat, lab_lens[base, label]
        else:
            start = indptr[base]
            src, length = flat, degrees[base]
        idx = (start[:, None] + cols[None, :]).clamp_(max=src.shape[0] - 1)
        cand = src[idx]
        ok = cols[None, :] < length[:, None]
        return cand, ok

    def base_degrees(degrees, pv, *, labs=None, label=None):
        if label is not None:
            return labs[2][pv, label]
        return degrees[pv]

    def pick_base(emb, degrees, preds, *, labs=None, label=None):
        pv = emb[:, list(preds)]                       # [C, P]
        if not cfg.dynamic_base or len(preds) == 1:
            return pv[:, -1]
        dg = base_degrees(degrees, pv, labs=labs, label=label)
        sel = torch.argmin(dg, dim=1)                  # first minimum
        return torch.take_along_dim(pv, sel[:, None], dim=1)[:, 0]

    def level_extras(i):
        """Restriction + injectivity comparisons at position i as
        ((emb column, dir), ...); dir ∈ {+1: >, -1: <, 0: !=}."""
        return tuple(plan.restr[i]) + tuple((j, 0) for j in plan.neqs[i])

    def expand_core(emb, base, preds, extras, indptr, degrees, flat,
                    width, *, want_counts=False, labs=None, label=None):
        """THE per-level admissibility core over rows that are all live
        (the caller expands only the selected rows).  Returns
        (cand, mask), or per-row int32 counts when `want_counts`."""
        cand, mask = gather_window(flat, indptr, degrees, base, width,
                                   labs=labs, label=label)
        if use_kernel and len(preds) > 1:
            us = emb[:, list(preds)].T.contiguous()               # [P, B]
            res = ops.level_expand(
                cand, flat, indptr[us], degrees[us],
                emb[:, [c for c, _ in extras]] if extras else None,
                mask,
                dirs=tuple(d for _, d in extras), count=want_counts,
                window=W,
            )
            return res if want_counts else (cand, res)
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

    def select_rows(rowmask, cap):
        """Compact indices of rows where rowmask → (sel_idx [cap] with C
        as the drop sentinel, sub_total)."""
        pos = torch.cumsum(rowmask, 0, dtype=I32) - 1
        total = pos[-1] + 1
        out_idx = torch.where(rowmask, pos.clamp(max=cap), cap)
        sel = torch.full((cap + 1,), C, dtype=I32, device=dev)
        sel[out_idx] = arangeC
        return sel[:cap], total

    def row_slices(sel_idx, sub_total, cap, width):
        """The live rows of a compacted sub-frontier (the reference's
        `sub_valid` prefix, min(sub_total, cap) rows), in slices of at
        most SLICE_ENTRIES candidates.  Reading the row count is a host
        sync; in exchange only live rows are ever expanded, so the work
        and memory of a level follow the frontier, not the capacity."""
        rows = min(int(sub_total), cap)
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
                     labs=None):
        """One level over the bucket layout.  Returns (new_emb,
        new_valid, needed) — or, at the last enumeration level,
        (count_contribution, None, needed)."""
        preds = plan.preds[i]
        extras = level_extras(i)
        label = vlabels[i]
        base_all = pick_base(emb, degrees, preds, labs=labs, label=label)
        db = base_degrees(degrees, base_all, labs=labs, label=label)
        last_enum = (plan.iep is None) and (i == n - 1)
        parent = torch.zeros((C + 1,), dtype=I32, device=dev)
        newcol = torch.zeros((C + 1,), dtype=I32, device=dev)
        offset = torch.zeros((), dtype=I64, device=dev)
        total_cnt = torch.zeros((), dtype=I64, device=dev)
        for bi, width, cap, lo, is_last in bucket_ranges():
            rowmask = valid & (db > lo)
            if not is_last:
                rowmask &= db <= width
            sel_idx, sub_total = select_rows(rowmask, cap)
            needed = torch.maximum(needed, scaled_need(sub_total, cap))
            for idx in row_slices(sel_idx, sub_total, cap, width):
                sub_emb = emb[idx][:, :i]
                sub_base = base_all[idx]
                if last_enum:
                    cnts = expand_core(
                        sub_emb, sub_base, preds, extras, indptr, degrees,
                        flat, width, want_counts=True, labs=labs,
                        label=label)
                    total_cnt += cnts.sum(dtype=I64)
                    continue
                cand, mask = expand_core(
                    sub_emb, sub_base, preds, extras, indptr, degrees, flat,
                    width, labs=labs, label=label)
                # stream-compact surviving (row, cand) pairs behind
                # `offset`; pairs past capacity land in the sentinel slot
                flat_mask = mask.reshape(-1)
                pos = torch.cumsum(flat_mask, 0, dtype=I64) - 1
                out_idx = torch.where(flat_mask, (offset + pos).clamp(max=C),
                                      C)
                parent[out_idx] = idx[:, None].expand(mask.shape).reshape(-1)
                newcol[out_idx] = cand.reshape(-1)
                offset = offset + (pos[-1] + 1)
        if last_enum:
            return total_cnt, None, needed
        new_emb = torch.cat(
            [emb[parent[:C]][:, :i], newcol[:C, None]], dim=1)
        new_valid = arangeC < offset
        needed = torch.maximum(needed, offset)
        return new_emb, new_valid, needed

    def iep_card_fused(sub_emb, sub_base, U, indptr, degrees, flat, width):
        """One IEP-term cardinality — |window ∩ (∩_q N(v_q))| minus the
        prefix-vertex corrections — in ONE kernel launch: the assigned
        prefix vertices ride along as negatively-weighted candidate
        columns (`neg_from`), so the signed popcount is raw − corr."""
        cand, ok = gather_window(flat, indptr, degrees, sub_base, width)
        comb = torch.cat([cand, sub_emb], dim=1)
        cvalid = torch.cat(
            [ok, torch.ones(sub_emb.shape, dtype=torch.bool, device=dev)],
            dim=1)
        us = sub_emb[:, list(U)].T.contiguous()                   # [P, B]
        signed = ops.level_expand(
            comb, flat, indptr[us], degrees[us], None, cvalid,
            dirs=(), count=True, neg_from=width, window=W,
        )
        return signed.to(I64)

    def iep_value(emb, valid, indptr, degrees, flat):
        """Per-row IEP count over the folded tail (int64), with bucketed
        union-window gathers through the shared expansion core."""
        iep = plan.iep
        cards = []
        needed_extra = torch.zeros((), dtype=I64, device=dev)
        for U in iep.unions:
            base = pick_base(emb, degrees, U)
            db = degrees[base]
            card = torch.zeros((C,), dtype=I64, device=dev)
            for bi, width, cap, lo, is_last in bucket_ranges():
                rowmask = valid & (db > lo)
                if not is_last:
                    rowmask &= db <= width
                sel_idx, sub_total = select_rows(rowmask, cap)
                needed_extra = torch.maximum(needed_extra,
                                             scaled_need(sub_total, cap))
                for idx in row_slices(sel_idx, sub_total, cap, width):
                    sub_emb = emb[idx]
                    sub_base = base[idx]
                    if use_kernel:
                        val = iep_card_fused(sub_emb, sub_base, U, indptr,
                                             degrees, flat, width)
                    else:
                        val = expand_core(
                            sub_emb, sub_base, U, (), indptr, degrees,
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

    def count(indptr, degrees, flat, labs, v0):
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
            thunk = partial(expand_level, i, emb, valid, needed,
                            indptr, degrees, flat, labs)
            out, new_valid, needed = (
                thunk() if level_cb is None else level_cb(i, thunk))
            if new_valid is None:          # last enumeration level
                return out, needed
            emb, valid = out, new_valid
        if plan.iep is None:
            # depth-1 == 0: single-vertex pattern — count valid v0 rows
            return valid.sum(dtype=I64), needed
        iep_thunk = partial(iep_value, emb, valid, indptr, degrees, flat)
        vals, need2 = (iep_thunk() if level_cb is None
                       else level_cb("iep", iep_thunk))
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
        self._traced_fns: dict[int, object] = {}  # --trace-sync twins
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

    def _make(self, capacity: int, level_cb=None):
        return _make_count_fn(
            self.plan, self._W, _bs_iters(self._W),
            replace(self.cfg, capacity=capacity), device=self.device,
            level_cb=level_cb)

    def _fn(self, capacity: int):
        if capacity not in self._fns:
            self._fns[capacity] = self._make(capacity)
        return self._fns[capacity]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _level_cb(self, i, thunk):
        """`--trace-sync` per-level hook: one `executor.level` span per
        schedule position, fenced with a device synchronize so the span
        duration is real device time, annotated with the surviving
        frontier size and the level's capacity demand."""
        with get_tracer().span("executor.level", level=i) as sp:
            out = thunk()
            self._sync()
            if isinstance(out, tuple) and len(out) == 3:
                _, new_valid, needed = out
                sp.set(needed=int(needed))
                if new_valid is not None:
                    sp.set(frontier=int(new_valid.sum()))
        return out

    def _traced_fn(self, capacity: int):
        """Twin of :meth:`_fn` with the per-level span hook — used only
        when the tracer asks for device-fenced levels (`--trace-sync`):
        the fencing serializes the pipeline."""
        if capacity not in self._traced_fns:
            self._traced_fns[capacity] = self._make(
                capacity, level_cb=self._level_cb)
        return self._traced_fns[capacity]

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
        int(needed)

    def release(self) -> None:
        """Drop every count function and device-tensor reference (the
        resident graph shared via ``arrays=`` stays alive at its owner).
        The matcher is unusable afterwards."""
        self._fns.clear()
        self._traced_fns.clear()
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
        doubled capacity so the count stays exact."""
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
        uninterrupted :meth:`count`)."""
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
            segment = 0
            while spans and (budget is None or segment < budget):
                s, e, cap = spans.pop()
                self._capacity = max(self._capacity, cap)
                width = min(chunk, cap)
                with tr.span("executor.dispatch", v0_start=s, v0_end=e,
                             capacity=cap, frontier=e - s) as dsp:
                    fn = (self._traced_fn(cap) if trace_sync
                          else self._fn(cap))
                    cnt, needed = fn(*call_args, self._v0(s, e, width))
                    # int() waits for the device, so the dispatch span
                    # covers real compute time
                    needed = int(needed)
                    dsp.set(needed=needed)
                segment += 1
                state.dispatches += 1
                state.max_needed = max(state.max_needed, needed)
                if needed > cap:
                    if e - s > 1:
                        mid = (s + e) // 2
                        spans += [(s, mid, cap), (mid, e, cap)]
                    elif cap < self.MAX_CAPACITY:
                        spans.append((s, e, cap * 2))   # escalate
                    else:
                        state.overflowed = True  # cannot split/grow further
                        state.total += int(cnt)
                    continue
                state.total += int(cnt)
            csp.set(dispatches=segment, max_needed=state.max_needed,
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
