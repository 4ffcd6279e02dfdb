"""Public wrappers of kernels K1–K4.

Counterpart of `repro/kernels/ops.py`.  `level_expand` (K1, with the
reference's padding contract), `level_expand_rows` (K1's count and
signed mode, candidates read from their CSR row) and
`level_expand_compact` (K1's mask mode with the level's stream
compaction, candidates read from their CSR row), `sorted_membership`
(K2) and `intersect_count` (K3) over stacked sorted rows, and
`flash_attention` (K4, in the model's [B, S, heads, hd] layout)
dispatch on where their tensors lie: CUDA tensors go to the
hand-written kernels (`intersect.level_expand_cuda`,
`intersect.level_rows_cuda`, `intersect.level_compact_cuda`,
`membership.membership_cuda`, `flash_attention.flash_attention_cuda`),
CPU tensors to the plain PyTorch versions (`ref.level_expand_ref`,
`ref.level_expand_rows_ref`, `ref.level_expand_compact_ref`,
`ref.membership_ref_searchsorted`, `ref.intersect_count_plain`,
`ref.flash_attention_ref`).  They never fall back from one to the
other: a build or launch failure raises.

On `meta` tensors (the dry-run's walk) K2, K3 and K4 return an empty
output of the kernel's shape and dtype and launch nothing; K1, whose
work is its rows' values, refuses them.  While a walk
(`roofline.op_cost.OpCost`) is active every call reports the kernel's
work on its inputs (`roofline.kernels`' bounds) to it, on every route,
and the plain version's own ops are not recorded: they stand for the
kernel.

`launches` counts entry calls that launched kernels: K1 per mode
(`mask`, `count`, `signed`, whichever entry launched it; one per call),
K2 as `membership`, K3 as `intersect_count`, K4 as `flash` (and per K4
kernel in `flash_attention.variant_launches`, per kernel of the
mask-and-compact entry in `intersect.compact_launches`, per K2/K3
kernel in `membership.kernel_launches`).  A count moves
only where its CUDA kernel is launched.
"""
from __future__ import annotations

import contextlib

import torch

from ..obs import get_tracer
from ..roofline import op_cost as _op_cost
from ..roofline.kernels import (bound_of, k4_bound, membership_bound,
                                rows_bound_of)
from . import flash_attention as _k4
from . import intersect as _k1
from . import membership as _k23
from .intersect import (level_compact_cuda, level_expand_cuda,
                        level_rows_cuda, load)
from .ref import (flash_attention_ref, intersect_count_plain,
                  level_expand_compact_ref, level_expand_ref,
                  level_expand_rows_ref, membership_ref_searchsorted)

CAND_PAD = -1
NBR_PAD = torch.iinfo(torch.int32).max

# device_graph pads the flat CSR array by flat_gather_pad() sentinels,
# as the reference does, so the device layout (and every window gather
# that runs past a row) is the same in both packages.
MAX_BLOCK_L = 512

# K1's limits, mirrored once from the CUDA source (which exports them,
# `intersect.load().level_expand_max_dirs()` / `level_rows_max_preds()`):
# comparisons per level, LE_MAX_DIRS (csrc/level_expand.cu:45), and
# predecessor rows of the row-sourced entries, LR_MAX_PREDS (:225).  The
# wrappers refuse more on either route; `analysis.kernel_contracts`
# proves the executor's call shapes stay within them.
MAX_DIRS = 16
MAX_PREDS = 16

K1_MODES = ("mask", "count", "signed")
launches = {**dict.fromkeys(K1_MODES, 0), "membership": 0,
            "intersect_count": 0, "flash": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    for k in _k4.variant_launches:
        _k4.variant_launches[k] = 0
    for k in _k1.compact_launches:
        _k1.compact_launches[k] = 0
    for k in _k23.kernel_launches:
        _k23.kernel_launches[k] = 0


def prepare(device) -> None:
    """Build and load K1 for tensors on `device` (its first use compiles
    it); CPU tensors take the plain version, which needs nothing."""
    if torch.device(device).type == "cuda":
        load()


def prepare_flash(device) -> None:
    """Build and load K4 for tensors on `device`, as `prepare` does K1."""
    if torch.device(device).type == "cuda":
        _k4.load()


def flat_gather_pad() -> int:
    """Sentinel entries appended to a flat CSR array on the device.

    The reference needs them so its in-kernel window DMAs stay in
    bounds; K1's binary search never reads outside a row, but the
    executor's candidate-window gathers read past the last rows, and
    keeping the reference's layout keeps both packages' arrays equal."""
    return MAX_BLOCK_L


def _route(device: torch.device) -> str:
    """Which version of a kernel runs for tensors on `device`: the CUDA
    kernel on a card, the plain version on the CPU, none on `meta` (an
    empty output: the dry-run's walk); anything else is refused."""
    if device.type == "cuda":
        return "kernel"
    if device.type == "cpu":
        return "plain"
    if device.type == "meta":
        return "meta"
    raise ValueError(f"the port's kernels run on cuda, cpu or meta, not "
                     f"{device}")


def _k1_route(device: torch.device) -> str:
    route = _route(device)
    if route == "meta":
        raise ValueError("K1's work depends on the values of its rows, and "
                         "meta tensors hold none: count on a device")
    return route


def _walk(n: int):
    """The active dry-run walk where a call with `n` rows does work,
    else None."""
    return _op_cost.active() if n else None


def _quiet(walk):
    """Leave the body out of `walk` (the plain version standing for a
    kernel)."""
    return walk.paused() if walk is not None else contextlib.nullcontext()


def _report(walk, key: str, shape, bound, *args, **kw) -> None:
    """Add one call of kernel `key` (an `ops.launches` key) to `walk`:
    the work `bound(*args, **kw)` counts on its inputs."""
    if walk is not None:
        with walk.paused():
            walk.kernel(key, bound(*args, **kw), shape)


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype} != {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, cand on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def level_expand(
    cand: torch.Tensor,                      # [B, D] candidate window
    flat: torch.Tensor,                      # [F] flat CSR indices array
    starts: torch.Tensor,                    # [P, B] CSR row offsets
    lens: torch.Tensor,                      # [P, B] valid row lengths
    extra: torch.Tensor | None = None,       # [B, E] prefix-vertex values
    cand_valid: torch.Tensor | None = None,  # [B, D] bool
    *,
    dirs: tuple = (),
    count: bool = False,
    neg_from: int | None = None,
    window: int,
) -> torch.Tensor:
    """One fused pass for a whole expansion level.

    mask[b, d] = cand_valid[b, d]
               ∧ (∀p: cand[b, d] ∈ flat[starts[p, b] : +lens[p, b]])
               ∧ (∀e: cand[b, d] <op dirs[e]> extra[b, e])
    with <op> ∈ {+1: >, -1: <, 0: !=}.  `count=True` returns
    cnt[b] = Σ_d mask[b, d] (int32) instead; with `neg_from` set,
    columns ≥ neg_from subtract instead of add (the fused IEP
    prefix-correction tail).

    Contracts (the reference's): rows flat[starts[p,b] : +lens[p,b]]
    strictly increasing; `window` ≥ every lens[p, b] (only the first
    `window` entries of a row are searched); every row inside `flat`.
    All integer inputs are int32 and every input is contiguous and on
    `cand`'s device; at most `MAX_DIRS` comparisons."""
    B, D, dirs, extra = validate_level_expand(
        cand, flat, starts, lens, extra, cand_valid, dirs=dirs, count=count,
        neg_from=neg_from)
    dev = cand.device
    mode = "mask" if not count else ("count" if neg_from is None
                                     else "signed")
    route, walk = _k1_route(dev), _walk(B)
    _report(walk, mode, (B, D), bound_of, cand, starts, lens, extra,
            cand_valid, count, window)
    if route == "plain":
        with _quiet(walk):
            return level_expand_ref(cand, flat, starts, lens, extra,
                                    cand_valid, dirs=dirs, count=count,
                                    neg_from=neg_from, window=window)
    if B == 0:
        shape = (0,) if count else (0, D)
        return torch.zeros(shape, dtype=torch.int32 if count else torch.bool,
                           device=dev)
    out = level_expand_cuda(cand, flat, starts, lens, extra, cand_valid,
                            dirs=dirs, count=count, neg_from=neg_from,
                            window=window)
    launches[mode] += 1
    return out


def _check_dirs(dirs, extra, B, dev):
    """(dirs as ints, extra or None): the comparisons' checks."""
    dirs = tuple(int(d) for d in dirs)
    if len(dirs) > MAX_DIRS:
        raise ValueError(f"{len(dirs)} comparisons exceed K1's {MAX_DIRS}")
    if dirs:
        if extra is None:
            raise ValueError("dirs given without extra")
        _check("extra", extra, torch.int32, (B, len(dirs)), dev)
        return dirs, extra
    return dirs, None


def validate_level_expand(cand, flat, starts, lens, extra=None,
                          cand_valid=None, *, dirs=(), count=False,
                          neg_from=None):
    """`level_expand`'s input checks — shapes, dtypes, devices, limits —
    which read no values, so they run on `meta` tensors too; returns
    (B, D, dirs, extra) with `dirs` as ints and `extra` None without
    them."""
    if cand.dim() != 2:
        raise ValueError(f"cand must be [B, D], got {tuple(cand.shape)}")
    B, D = cand.shape
    dev = cand.device
    if starts.dim() != 2 or starts.shape[1] != B or starts.shape[0] < 1:
        raise ValueError(f"starts must be [P>=1, {B}], got "
                         f"{tuple(starts.shape)}")
    P = starts.shape[0]
    _check("cand", cand, torch.int32, (B, D), dev)
    _check("flat", flat, torch.int32, None, dev)
    if flat.dim() != 1:
        raise ValueError(f"flat must be 1-D, got {tuple(flat.shape)}")
    _check("starts", starts, torch.int32, (P, B), dev)
    _check("lens", lens, torch.int32, (P, B), dev)
    if cand_valid is not None:
        _check("cand_valid", cand_valid, torch.bool, (B, D), dev)
    dirs, extra = _check_dirs(dirs, extra, B, dev)
    if neg_from is not None and not count:
        raise ValueError("neg_from needs count=True")
    return B, D, dirs, extra


def _check_rows(csrc, cstart, clen, flat, starts, lens, own, extra, dirs,
                width):
    """The row-sourced entries' common input checks, which read no
    values; returns (P, B, device, dirs, extra) with `dirs` as ints and
    `extra` None without them.  At most `MAX_PREDS` predecessors."""
    for name, t in (("csrc", csrc), ("flat", flat)):
        if isinstance(t, torch.Tensor) and t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
    if not isinstance(starts, torch.Tensor) or starts.dim() != 2 \
            or starts.shape[0] < 1:
        raise ValueError("starts must be a [P>=1, B] tensor")
    P, B = starts.shape
    if P > MAX_PREDS:
        raise ValueError(f"{P} predecessors exceed K1's {MAX_PREDS}")
    dev = csrc.device if isinstance(csrc, torch.Tensor) else None
    _check("csrc", csrc, torch.int32, None, dev)
    _check("cstart", cstart, torch.int32, (B,), dev)
    _check("clen", clen, torch.int32, (B,), dev)
    _check("flat", flat, torch.int32, None, dev)
    _check("starts", starts, torch.int32, (P, B), dev)
    _check("lens", lens, torch.int32, (P, B), dev)
    if own is not None:
        _check("own", own, torch.int32, (B,), dev)
    dirs, extra = _check_dirs(dirs, extra, B, dev)
    if int(width) < 0:
        raise ValueError(f"width must be >= 0, got {width}")
    return P, B, dev, dirs, extra


def _check_own(own, P: int, B: int) -> None:
    """The value check of the row-sourced entries: own's range, read on
    the host once (a sync: the span `device.sync` at `k1_own`), where
    `own` is given."""
    if own is not None and B:
        lo_hi = torch.aminmax(own)
        with get_tracer().span("device.sync", site="k1_own", rows=B):
            lo, hi = (int(v) for v in lo_hi)
        if lo < -1 or hi >= P:
            raise ValueError(f"own outside [-1, {P}): [{lo}, {hi}]")


def validate_level_expand_rows(csrc, cstart, clen, flat, starts, lens,
                               own=None, extra=None, neg=None, *, dirs=(),
                               width):
    """`level_expand_rows`'s checks that read no values (they run on
    `meta` tensors too); returns (P, B, device, dirs, extra)."""
    P, B, dev, dirs, extra = _check_rows(csrc, cstart, clen, flat, starts,
                                         lens, own, extra, dirs, width)
    if neg is not None:
        if neg.dim() != 2:
            raise ValueError(f"neg must be [B, Q], got {tuple(neg.shape)}")
        _check("neg", neg, torch.int32, (B, neg.shape[1]), dev)
    return P, B, dev, dirs, extra


def level_expand_rows(
    csrc: torch.Tensor,                      # [F'] candidate rows' array
    cstart: torch.Tensor,                    # [B] candidate row offsets
    clen: torch.Tensor,                      # [B] candidate row lengths
    flat: torch.Tensor,                      # [F] flat CSR indices array
    starts: torch.Tensor,                    # [P, B] CSR row offsets
    lens: torch.Tensor,                      # [P, B] valid row lengths
    own: torch.Tensor | None = None,         # [B] row holding the cands
    extra: torch.Tensor | None = None,       # [B, E] prefix-vertex values
    neg: torch.Tensor | None = None,         # [B, Q] signed-mode columns
    *,
    dirs: tuple = (),
    width: int,
    window: int,
) -> torch.Tensor:
    """K1's count (`neg` None) and signed mode with the candidates read
    from their row: int32 [B], equal bit for bit to the gathered window
    `cand = csrc[cstart[b] : + width]` (columns d < clen[b] valid), with
    `neg` appended in signed mode, through `level_expand(..., count=True,
    neg_from=width)`.

    Contracts: each candidate row csrc[cstart[b] : + min(clen[b],
    width)] lies inside `csrc` and is strictly increasing, as are the
    predecessor rows (`level_expand`'s contract, `window` ≥ every
    lens[p, b]); own[b] ∈ [-1, P) names a predecessor whose row holds
    every candidate of row b (-1: none), so the kernel skips searching
    it.  All integer inputs are int32, contiguous and on `csrc`'s
    device; an `own` outside [-1, P) is refused (one read of its range
    on the host); at most `MAX_PREDS` predecessors and `MAX_DIRS`
    comparisons."""
    P, B, dev, dirs, extra = validate_level_expand_rows(
        csrc, cstart, clen, flat, starts, lens, own, extra, neg, dirs=dirs,
        width=width)
    route = _k1_route(dev)
    _check_own(own, P, B)
    mode, walk = "count" if neg is None else "signed", _walk(B)
    _report(walk, mode, (B,), rows_bound_of, csrc, cstart, clen, flat,
            starts, lens, own, extra, neg, dirs=dirs, width=width,
            window=window)
    if route == "plain":
        with _quiet(walk):
            return level_expand_rows_ref(csrc, cstart, clen, flat, starts,
                                         lens, own, extra, neg, dirs=dirs,
                                         width=width, window=window)
    if B == 0:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    out = level_rows_cuda(csrc, cstart, clen, flat, starts, lens, own, extra,
                          neg, dirs=dirs, width=width, window=window)
    launches[mode] += 1
    return out


def level_expand_compact(
    csrc: torch.Tensor,                      # [F'] candidate rows' array
    cstart: torch.Tensor,                    # [B] candidate row offsets
    clen: torch.Tensor,                      # [B] candidate row lengths
    flat: torch.Tensor,                      # [F] flat CSR indices array
    starts: torch.Tensor,                    # [P, B] CSR row offsets
    lens: torch.Tensor,                      # [P, B] valid row lengths
    own: torch.Tensor | None,                # [B] row holding the cands
    extra: torch.Tensor | None,              # [B, E] prefix-vertex values
    rows: torch.Tensor,                      # [B] frontier row of each b
    offset: torch.Tensor,                    # 0-d int64 running position
    parent: torch.Tensor,                    # [C + 1] int32 out
    newcol: torch.Tensor,                    # [C + 1] int32 out
    *,
    dirs: tuple = (),
    width: int,
    window: int,
) -> None:
    """K1's mask mode with the level's stream compaction, in place: the
    admissible candidates of each row (as `level_expand_rows` decides
    them, from csrc[cstart[b] : + min(clen[b], width)]) are written, in
    (row, column) order, as the pairs (rows[b], candidate) to `parent` /
    `newcol` at offset, offset + 1, ...; positions at or past C =
    len(parent) - 1 are dropped, and `offset` advances by the total,
    dropped pairs included.  Over parent[:C], newcol[:C] and `offset`
    this equals, bit for bit, the gathered window through
    `level_expand` in mask mode followed by the executor's compaction
    (`ref.compact_pairs`); slot C is scratch.

    Contracts: `level_expand_rows`'s, and `rows` int32 [B], `offset` an
    int64 0-d tensor, `parent` / `newcol` int32 [C + 1] with C >= 0, all
    contiguous and on `csrc`'s device."""
    P, B, dev, dirs, extra = validate_level_expand_compact(
        csrc, cstart, clen, flat, starts, lens, own, extra, rows, offset,
        parent, newcol, dirs=dirs, width=width)
    route = _k1_route(dev)
    _check_own(own, P, B)
    walk = _walk(B)
    off0 = int(offset) if walk is not None else 0
    if route == "plain":
        with _quiet(walk):
            level_expand_compact_ref(csrc, cstart, clen, flat, starts, lens,
                                     own, extra, rows, offset, parent, newcol,
                                     dirs=dirs, width=width, window=window)
    elif B:
        level_compact_cuda(csrc, cstart, clen, flat, starts, lens, own, extra,
                           rows, offset, parent, newcol, dirs=dirs,
                           width=width, window=window)
        launches["mask"] += 1
    if walk is not None:
        # pairs written below the capacity C (the rest are dropped)
        total, C = int(offset) - off0, parent.shape[0] - 1
        _report(walk, "mask", (B,), rows_bound_of, csrc, cstart, clen, flat,
                starts, lens, own, extra, None, dirs=dirs, width=width,
                window=window, written=max(min(total, C - off0), 0))


def validate_level_expand_compact(csrc, cstart, clen, flat, starts, lens,
                                  own, extra, rows, offset, parent, newcol,
                                  *, dirs=(), width):
    """`level_expand_compact`'s checks that read no values (they run on
    `meta` tensors too); returns (P, B, device, dirs, extra)."""
    P, B, dev, dirs, extra = _check_rows(csrc, cstart, clen, flat, starts,
                                         lens, own, extra, dirs, width)
    _check("rows", rows, torch.int32, (B,), dev)
    _check("offset", offset, torch.int64, (), dev)
    if not isinstance(parent, torch.Tensor) or parent.dim() != 1 \
            or parent.shape[0] < 1:
        raise ValueError("parent must be a [C + 1] tensor, C >= 0")
    _check("parent", parent, torch.int32, None, dev)
    _check("newcol", newcol, torch.int32, tuple(parent.shape), dev)
    return P, B, dev, dirs, extra


# ------------------------------------------------- stacked membership ---
def _membership_inputs(cand, nbr, cand_valid, nbr_len, blocks):
    """K2/K3's input checks; returns (cand, nbr) widened to int32."""
    for name, t in (("cand", cand), ("nbr", nbr)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
        if t.dtype.is_floating_point or t.dtype.is_complex \
                or t.dtype == torch.bool:
            raise TypeError(f"{name} must be an integer tensor, got "
                            f"{t.dtype}")
    if nbr.shape[0] != cand.shape[0]:
        raise ValueError(f"cand {tuple(cand.shape)} and nbr "
                         f"{tuple(nbr.shape)} differ in rows")
    if any(int(b) < 1 for b in blocks):
        raise ValueError(f"block sizes must be positive, got {blocks}")
    dev = cand.device
    if nbr.device != dev:
        raise ValueError(f"nbr on {nbr.device}, cand on {dev}")
    B = cand.shape[0]
    if cand_valid is not None:
        _check("cand_valid", cand_valid, torch.bool, tuple(cand.shape), dev)
    if nbr_len is not None:
        if (not isinstance(nbr_len, torch.Tensor)
                or tuple(nbr_len.shape) != (B,) or nbr_len.device != dev
                or nbr_len.dtype.is_floating_point):
            raise ValueError(f"nbr_len must be an integer [{B}] tensor on "
                             f"{dev}")
    return cand.to(torch.int32), nbr.to(torch.int32)


def _stacked_rows(cand, nbr, cand_valid, nbr_len, blocks):
    """The reference's input contract of K2/K3 (`repro/kernels/ops.py:
    61-69, 94-102`), as int32 contiguous tensors: integer inputs
    widened, invalid candidates set to CAND_PAD and row positions at or
    past `nbr_len[b]` to NBR_PAD, so every row stays non-decreasing.
    The plain route's inputs; the kernel reads the same contract from
    the raw rows."""
    cand, nbr = _membership_inputs(cand, nbr, cand_valid, nbr_len, blocks)
    if cand_valid is not None:
        cand = torch.where(cand_valid, cand, CAND_PAD)
    if nbr_len is not None:
        pos = torch.arange(nbr.shape[1], dtype=torch.int32,
                           device=nbr.device)
        nbr = torch.where(pos[None, :] < nbr_len[:, None], nbr, NBR_PAD)
    return cand.contiguous(), nbr.contiguous()


def _membership(cand, nbr, cand_valid, nbr_len, blocks, *, count: bool):
    dev = cand.device if isinstance(cand, torch.Tensor) else None
    route = _route(dev) if dev is not None else "kernel"
    key = "intersect_count" if count else "membership"
    ragged = cand_valid is not None or nbr_len is not None
    if route in ("plain", "meta"):
        _membership_inputs(cand, nbr, cand_valid, nbr_len, blocks)
        (B, D), L = cand.shape, nbr.shape[1]
        walk = _walk(B * D * L)
        _report(walk, key, (B, D), membership_bound, B, D, L, count,
                ragged=ragged)
        if route == "meta":
            return torch.empty((B,) if count else (B, D),
                               dtype=torch.int32 if count else torch.bool,
                               device=dev)
        with _quiet(walk):
            cand, nbr = _stacked_rows(cand, nbr, cand_valid, nbr_len, blocks)
            return (intersect_count_plain(cand, nbr) if count
                    else membership_ref_searchsorted(cand, nbr))
    cand, nbr = _membership_inputs(cand, nbr, cand_valid, nbr_len, blocks)
    B, D = cand.shape
    L = nbr.shape[1]
    if B == 0 or D == 0 or L == 0:
        # nothing to launch: no candidate, or every row empty
        if count:
            return torch.zeros((B,), dtype=torch.int32, device=dev)
        return torch.zeros((B, D), dtype=torch.bool, device=dev)
    if nbr_len is not None:      # [B] only: the [B, L] rows go as they are
        nbr_len = nbr_len.to(torch.int64).clamp(0, L).to(torch.int32)
    out = _k23.membership_cuda(cand.contiguous(), nbr.contiguous(), nbr_len,
                               cand_valid, count=count)
    launches[key] += 1
    _report(_walk(1), key, (B, D), membership_bound, B, D, L, count,
            ragged=ragged)
    return out


def sorted_membership(
    cand: torch.Tensor,                      # [B, D] integer
    nbr: torch.Tensor,                       # [B, L] integer, rows sorted
    cand_valid: torch.Tensor | None = None,  # [B, D] bool
    nbr_len: torch.Tensor | None = None,     # [B] valid row lengths
    *,
    block_b: int = 8,
    block_d: int = 128,
    block_l: int = 128,
) -> torch.Tensor:
    """K2: mask[b, d] = cand[b, d] ∈ nbr[b, :nbr_len[b]] (bool [B, D]).

    The reference's contract: any integer dtype (widened to int32), rows
    sorted ascending, `cand_valid` / `nbr_len` mask ragged tails and
    padding never matches.  The domain is cand ∈ [-1, INT32_MAX): the
    reference pads rows to `block_l` multiples with INT32_MAX, so its
    answer for a candidate equal to INT32_MAX depends on the block size;
    vertex ids never reach it, and the port does not reproduce that.
    `block_b` / `block_d` / `block_l` are accepted for the reference's
    signature; the kernel tiles rows its own way, and the result never
    depends on them.  CUDA tensors launch the kernel, CPU tensors run the
    plain version."""
    return _membership(cand, nbr, cand_valid, nbr_len,
                       (block_b, block_d, block_l), count=False)


def intersect_count(
    cand: torch.Tensor,
    nbr: torch.Tensor,
    cand_valid: torch.Tensor | None = None,
    nbr_len: torch.Tensor | None = None,
    *,
    block_b: int = 8,
    block_d: int = 128,
    block_l: int = 128,
) -> torch.Tensor:
    """K3: cnt[b] = #{d : cand[b, d] ∈ nbr[b, :nbr_len[b]]} (int32 [B]);
    duplicate candidates count separately.  As `sorted_membership`, and
    the reference's contract: the valid prefix of each row strictly
    increasing."""
    return _membership(cand, nbr, cand_valid, nbr_len,
                       (block_b, block_d, block_l), count=True)


# ------------------------------------------------------------ attention ---

def flash_attention_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """K4 in its own layout: q [BH, Sq, hd], k/v [BK, Sk, hd] with
    BH % BK == 0; float32 or bfloat16, all of one dtype, contiguous, on
    one device.  Returns o [BH, Sq, hd] in q's dtype."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q/k/v must be 3-D, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, Sq, hd = q.shape
    BK, Sk, _ = k.shape
    if tuple(k.shape) != (BK, Sk, hd) or tuple(v.shape) != (BK, Sk, hd):
        raise ValueError(f"k/v must be [BK, Sk, {hd}] alike, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if min(BH, BK, Sq, Sk, hd) < 1 or BH % BK:
        raise ValueError(f"need non-empty shapes and BH % BK == 0, got "
                         f"BH={BH} BK={BK} Sq={Sq} Sk={Sk} hd={hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _k4.DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype}: q, k and v must share "
                            f"one of {list(_k4.DTYPES)}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    route, walk = _route(q.device), _walk(1)
    _report(walk, "flash", (BH, Sq, hd), k4_bound, (BH, BK, Sq, Sk, hd),
            causal, elem=q.element_size())
    if route == "meta":
        return torch.empty_like(q)
    if route == "plain":
        with _quiet(walk):
            return flash_attention_ref(q, k, v, causal=causal)
    out = _k4.flash_attention_cuda(q, k, v, causal=causal)
    launches["flash"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """Model-layout wrapper: q [B, Sq, H, hd], k/v [B, Sk, K, hd] →
    [B, Sq, H, hd].  (B, heads) fold into the kernel's row axis with the
    H // K query heads of one KV group adjacent, so kernel row i reads
    KV row i // (H // K): the KV heads are never copied per query head."""
    B, Sq, H, hd = q.shape
    _, Sk, K, _ = k.shape
    # reshape may return a strided view (B == 1): make the rows dense
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd).contiguous()
    kf = k.transpose(1, 2).reshape(B * K, Sk, hd).contiguous()
    vf = v.transpose(1, 2).reshape(B * K, Sk, hd).contiguous()
    of = flash_attention_rows(qf, kf, vf, causal=causal)
    return of.reshape(B, H, Sq, hd).transpose(1, 2)
