"""FLOP, byte, collective and peak-memory accounting of one eager step:
the port's counterpart of `repro/roofline/hlo_cost.py`.

The reference parses XLA's compiled HLO and multiplies `while` bodies
by their trip counts.  The port has no HLO: one rank's step runs once,
eagerly (on `meta` tensors for the LM cells), under `OpCost`, a
`TorchDispatchMode` that sees every aten op, the backward pass's
included.  A layer that runs 80 times is recorded 80 times, so there is
no trip count to multiply through.  The reference's rules, translated
to aten ops:

    flops    = Σ matmul-family FLOP (mm, addmm, bmm, baddbmm, the
               convolutions and their backward; einsum reaches these):
               2 · numel(out) · K, from `torch.utils.flop_counter`.
               Elementwise FLOPs are ignored, as the reference's are.
    bytes    = Σ over ops: inputs read + outputs written, except
               * views (`view`, `transpose`, `expand`, `slice`, ...:
                 any op whose result aliases an input without writing
                 it, and `_unsafe_view`) and `empty*` factories: free
                 (`_SKIP_BYTES_OPS`, `hlo_cost.py:45`);
               * gathers (`embedding`, `index_select`, `gather`,
                 advanced indexing) read the gathered window plus the
                 indices, not the table (`_SLICED_READ`, :232-272);
               * writes into a slice or view (`copy_`, `index_copy_`,
                 `index_put_`, `scatter_*`) bill the update window, not
                 the buffer (dynamic-update-slice, :274-287): the
                 KV-cache update.
    kernels  = K1–K4 add their own FLOP (K4) or compares (K1–K3) and
               bytes from `roofline.kernels`: their wrappers report to
               the active walk (`kernel`), and the ops that stand for a
               kernel off the card (its plain version) are not recorded.
    colls    = the deltas of `parallel.tp`'s `moved` over the walk,
               ring-factored on the result sizes as `hlo_cost.py:
               334-351`: all-reduce x2, all-gather x1 of its result
               (g times its input), reduce-scatter x g of its result
               (its input).
    peak     = the step's arguments (`hold`) plus the high-water mark
               of the bytes of the storages the step allocates, each
               freed when its last tensor goes (a weak reference to the
               storage).  The counterpart of `memory_analysis`.

These bytes are eager op-boundary bytes: what the port moves today, and
an upper bound on what a fused program of the same step would move.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from collections import defaultdict
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..parallel import tp

_MATMULS = ("mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
            "convolution_backward")
_FREE = {"_unsafe_view", "empty", "empty_like", "empty_strided",
         "new_empty", "new_empty_strided"}
_WRITE_ONLY = {"fill_", "zero_"}
_GATHERS = {"embedding", "index_select", "gather", "index", "_unsafe_index"}
# tp kind → (the reference's collective, the grid axis of its group)
_KINDS = {"all_reduce": ("all-reduce", None), "all_max": ("all-reduce", None),
          "all_gather": ("all-gather", "model"),
          "gather_batch": ("all-gather", "data"),
          "gather_data": ("all-gather", "data"),
          "reduce_scatter": ("reduce-scatter", None)}

_ACTIVE: list["OpCost"] = []


def active() -> "OpCost | None":
    """The innermost walk in progress, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree) -> list:
    """The tensors in an op's arguments or results (tuples, lists and
    dicts of them).  A loop, not a recursive closure: a closure that
    calls itself is a reference cycle, which would keep the tensors it
    saw alive until the next garbage collection."""
    out, todo = [], [tree]
    while todo:
        v = todo.pop()
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            todo.extend(reversed(v))
        elif isinstance(v, dict):
            todo.extend(reversed(list(v.values())))
    return out


_KINDS_OF: dict = {}


def _kind(func) -> tuple[bool, bool, bool]:
    """(composite, view, fresh) of an op, once per op: a
    CompositeImplicitAutograd op decomposes into others; a view's
    results alias an input without writing it; a fresh op's results are
    new storages (no result aliases an input)."""
    k = _KINDS_OF.get(func)
    if k is None:
        rets = func._schema.returns
        view = bool(rets) and all(r.alias_info is not None
                                  and not r.alias_info.is_write
                                  for r in rets)
        fresh = (all(r.alias_info is None for r in rets)
                 and func.overloadpacket.__name__ != "_unsafe_view")
        k = _KINDS_OF[func] = (
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd),
            view, fresh)
    return k


def _put_window(self_, indices) -> int:
    """Elements `self_[indices]` selects (integer index tensors, None for
    a whole dim); a boolean mask bills the whole buffer (its count is
    data)."""
    idx = list(indices)
    given = [i for i in idx if i is not None]
    if not given or any(i.dtype == torch.bool for i in given):
        return self_.numel()
    n = math.prod(torch.broadcast_shapes(*(i.shape for i in given)))
    return n * math.prod(d for k, d in enumerate(self_.shape)
                         if k >= len(idx) or idx[k] is None)


def op_bytes(name: str, func, args, kwargs, out) -> float:
    """Bytes one aten op reads and writes, by the rules above."""
    if name in _FREE or _kind(func)[1]:
        return 0.0
    outs = _tensors(out)
    written = sum(nbytes(t) for t in outs)
    if name in _GATHERS:
        idx = _tensors(args[1:]) + _tensors(kwargs)
        return 2 * written + sum(nbytes(t) for t in idx)
    if name == "copy_":
        return nbytes(args[1]) + nbytes(args[0])
    if name in _WRITE_ONLY:
        return written + sum(nbytes(t) for t in _tensors(args[1:]))
    if name in ("index_put_", "_index_put_impl_"):
        self_, indices, values = args[:3]
        acc = len(args) > 3 and bool(args[3])
        win = _put_window(self_, indices) * self_.element_size()
        return (nbytes(values) + sum(nbytes(i) for i in _tensors(indices))
                + win * (2 if acc else 1))
    if name in ("index_copy_", "index_add_"):
        self_, _, index, source = args[:4]
        win = nbytes(source)
        return (win + nbytes(index) + win * (2 if name == "index_add_"
                                             else 1))
    if name in ("scatter_", "scatter_add_"):
        self_, _, index = args[:3]
        src = args[3] if len(args) > 3 else None
        win = index.numel() * self_.element_size()
        read = nbytes(index) + (index.numel() * src.element_size()
                                if isinstance(src, torch.Tensor) else 0)
        return read + win * (1 if name == "scatter_" else 2)
    reads = _tensors(args) + _tensors({k: v for k, v in kwargs.items()
                                       if k != "out"})
    return sum(nbytes(t) for t in reads) + written


@dataclass
class Contribution:
    bytes_: float = 0.0
    flops: float = 0.0
    count: int = 0


class OpCost(TorchDispatchMode):
    """Record one step: ``with OpCost(grid) as rec: step(...)``, then
    `rec.flops`, `rec.bytes_`, `rec.coll` (bytes per reference
    collective kind), `rec.peak_bytes`, `rec.kernels` (K1–K4 calls by
    entry), `rec.compares` (K1–K3's) and `rec.by_sig` (per op
    signature, for `explain`).  `grid` gives the collectives' group
    sizes (None: one device)."""

    def __init__(self, grid=None):
        super().__init__()
        self.grid = grid
        self.flops = 0.0
        self.bytes_ = 0.0
        self.compares = 0.0
        self.by_sig: dict[str, Contribution] = defaultdict(Contribution)
        self.kernels: dict[str, int] = defaultdict(int)
        self.coll: dict[str, float] = {}
        self.args_bytes = 0
        self.live = 0
        self.high = 0
        self._held: set = set()
        self._storages: dict[int, int] = {}
        self._paused = 0
        self._depth = 0
        self._moved0: dict = {}

    # ------------------------------------------------------- the walk
    def __enter__(self):
        if not self._depth:
            self._moved0 = dict(tp.moved)
            _ACTIVE.append(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if not self._depth:
                _ACTIVE.remove(self)
                self._collectives()

    @property
    def peak_bytes(self) -> int:
        return self.args_bytes + self.high

    def hold(self, *trees) -> None:
        """Count the storages of `trees` (the step's params, state,
        batch, cache) as its arguments: held for the whole step."""
        for t in _tensors(trees):
            key = t.untyped_storage()._cdata
            if key not in self._held:
                self._held.add(key)
                self.args_bytes += t.untyped_storage().nbytes()

    @contextlib.contextmanager
    def paused(self):
        """Run the body unrecorded (its new storages are still tracked
        for the peak)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def add(self, sig: str, nbytes_: float, flops: float = 0.0) -> None:
        c = self.by_sig[sig]
        c.bytes_ += nbytes_
        c.flops += flops
        c.count += 1
        self.bytes_ += nbytes_
        self.flops += flops

    def kernel(self, key: str, bound, shape) -> None:
        """One call of kernel `key` (an `ops.launches` key) doing the
        work of `bound` (a `roofline.kernels.Bound`): K4's ("flash")
        operations are matmul FLOP, K1–K3's compares."""
        self.kernels[key] += 1
        sig = f"kernel {key} -> {list(shape)}"
        if key == "flash":
            self.add(sig, bound.nbytes, bound.ops)
        else:
            self.compares += bound.ops
            self.add(sig, bound.nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        composite, _, fresh = _kind(func)
        if composite:
            # a composite (`matmul` under inference mode): record its
            # parts, through this mode again
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func.namespace != "aten":
            return out                 # collectives: `parallel.tp`'s
        if fresh:
            self._track(out)
        if self._paused:
            return out
        name = func.overloadpacket.__name__
        flops = 0.0
        if name in _MATMULS:
            from torch.utils.flop_counter import flop_registry

            flops = float(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
        nb = op_bytes(name, func, args, kwargs, out)
        if nb or flops:
            first = next(iter(_tensors(out)), None)
            sig = (name if first is None else
                   f"{name} -> {str(first.dtype).removeprefix('torch.')}"
                   f"{list(first.shape)}")
            self.add(sig, nb, flops)
        return out

    # ------------------------------------------------------- the peak
    def _track(self, out) -> None:
        """Count the new storages of a fresh op's results."""
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held or key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live += n
            self.high = max(self.high, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    # ------------------------------------------------ the collectives
    def _collectives(self) -> None:
        shape = {} if self.grid is None else self.grid.shape
        model = shape.get("model", 1)
        data = math.prod(shape.values()) // model if shape else 1
        out: dict[str, float] = {}
        for kind, (ref, axis) in _KINDS.items():
            moved = tp.moved[kind] - self._moved0.get(kind, 0)
            if not moved:
                continue
            factor = {"all-reduce": 2, "reduce-scatter": 1}.get(ref)
            if factor is None:          # all-gather: its result
                factor = model if axis == "model" else data
            out[ref] = out.get(ref, 0.0) + moved * factor
        self.coll = out
