"""Sharding rules: map parameter / batch / cache trees to specs, and
each rank's part of them.

Counterpart of `repro/parallel/sharding.py`.  The reference hands its
specs to GSPMD; the port runs one process per GPU, so it also says
which slice of each tensor a rank holds (`partition`, `local_batch`,
`kv_layout`).

Grids (`Grid`, the counterpart of a `jax.sharding.Mesh` that needs no
devices):
    single pod:  ("data", "model")            = (16, 16)
    multi-pod:   ("pod", "data", "model")     = (2, 16, 16)
    a launch:    ("data", "model")            = (W // M, M)
`DP` below = all data-parallel axes (pod+data); `MP` = "model".

A spec is a tuple with one entry per dimension: None, "model", "data"
or ("pod", "data"), equal to `tuple(PartitionSpec)` of the reference.

Parameter policy (2-D: TP over model, FSDP over data — ZeRO-3-like):
    embed [V, d]           (MP, DP)     vocab over model, FSDP over d
    wq/wk/wv [d, Hhd]      (DP, MP)
    wo [Hhd, d]            (MP, DP)
    mlp gate/up [d, ff]    (DP, MP)
    mlp down [ff, d]       (MP, DP)
    moe gate/up [E, d, f]  (MP, DP, ∅)  expert-parallel over model
    moe down [E, f, d]     (MP, ∅, DP)
    moe router [d, E]      (DP, ∅)
    mamba in_proj [d, P]   (DP, MP)
    mamba out_proj [di,d]  (MP, DP)
    1-D params             replicated
The port's trees hold one dict per layer where the reference stacks
layers for `lax.scan`: a leaf's path is the reference's key path
without the list index, and its spec is the reference's without the
leading stack entries (which the reference pads with None).

What a rank holds follows `pick_layout`, as in the reference.  Under
'tp2d' a rank's part in serving (`partition`) follows the specs'
"model" entries; in training (`train_piece`) a rank holds the
intersection of that model-axis part and its block of the DP entry's
dim (`data_partition`, ZeRO-3 over the data axis), with the moments
laid out like the params (`opt_state_shardings`).  Under
'dp_replicated' every rank holds every leaf whole and takes its rows
of the batch over every axis (`local_batch`).  The designed
differences from the reference's specs:
 * in serving the DP entries are not applied: each data group holds a
   whole model-axis shard (the batch is still split over data);
 * wk / wv stay whole where the KV heads do not divide the model axis
   (granite-34b's one KV head); the reference shards their columns and
   GSPMD regathers them;
 * under 'tp2d', attention whose query heads the model axis does not
   divide (minitron-4b's 24 at 16) is whole on every model rank: wq,
   wk, wv, wo and the q / k norms (their DP blocks still apply in
   training); the reference shards wq / wo by columns mid-head and
   GSPMD regathers them;
 * a Mamba block is split by heads (z, x, dt, A_log, D, dt_bias, the
   gated norm's scale, x's conv channels and out_proj's rows), its one
   B/C group replicated; the reference's spec cuts the packed in_proj
   columns z | x | B | C | dt into contiguous pieces;
 * the enc-dec cross-attention cache is split by heads like the
   self-attention it comes from, where the reference's spec splits its
   sequence;
 * under 'dp_replicated' the decode cache holds the rank's rows whole
   (every head and position), where the reference's follows
   `choose_kv_spec`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

MP = "model"


@dataclass(frozen=True, eq=False)
class Grid:
    """Named axes and their sizes (`shape` maps name → size, as a
    mesh's does).  A launch's grid also knows this process's rank and
    the process groups of its model and data axes and of all its ranks
    (`group`; `launch.mesh.make_grid`); a grid built for specs alone
    has none."""

    axis_names: tuple
    sizes: tuple
    rank: int = 0
    model_group: Any = None
    data_group: Any = None
    group: Any = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def model(self) -> int:
        return self.shape.get(MP, 1)

    @property
    def data(self) -> int:
        return self.size // self.model

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model


def grid(shape: tuple, names: tuple) -> Grid:
    """A grid for specs alone (the production meshes need no devices)."""
    if len(shape) != len(names):
        raise ValueError(f"shape {shape} and names {names} differ in length")
    return Grid(tuple(names), tuple(int(s) for s in shape))


def _size(mesh: Grid, axes) -> int:
    axes = axes if isinstance(axes, tuple) else (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def dp_axes(mesh: Grid):
    names = mesh.axis_names
    dp = tuple(a for a in names if a in ("pod", "data"))
    return dp if len(dp) > 1 else (dp[0] if dp else None)


# (path-suffix match, spec for the trailing (non-stacked) dims)
_RULES: list[tuple[tuple[str, ...], tuple[Any, ...]]] = [
    (("embed", "w"), (MP, "DP")),
    (("lm_head", "w"), ("DP", MP)),
    (("wq", "w"), ("DP", MP)),
    (("wk", "w"), ("DP", MP)),
    (("wv", "w"), ("DP", MP)),
    (("wo", "w"), (MP, "DP")),
    (("gate", "w"), ("DP", MP)),
    (("up", "w"), ("DP", MP)),
    (("down", "w"), (MP, "DP")),
    (("router", "w"), ("DP", None)),
    # moe expert tensors (no trailing 'w' — raw [E, ..] arrays)
    (("mlp", "gate"), (MP, "DP", None)),
    (("mlp", "up"), (MP, "DP", None)),
    (("mlp", "down"), (MP, None, "DP")),
    (("in_proj", "w"), ("DP", MP)),
    (("out_proj", "w"), (MP, "DP")),
    (("conv_w",), (None, MP)),
]


def _match(path: tuple[str, ...], suffix: tuple[str, ...]) -> bool:
    return len(path) >= len(suffix) and tuple(path[-len(suffix):]) == suffix


def pick_layout(cfg, mesh: Grid) -> str:
    """The reference's analytic layout choice: 'tp2d' (params 2-D
    sharded, TP×FSDP) by default; 'dp_replicated' (params replicated,
    batch over every axis) for a model whose replicated params and
    optimizer state fit the reference's 16 GB budget and whose head
    count cannot fill the model axis.  Serving and training both follow
    it (whisper-base at a model axis of 3 or 16 takes 'dp_replicated');
    `partition` and `local_batch` say what a rank then holds."""
    m = mesh.shape[MP]
    fits = cfg.param_count() * 16 < 6e9
    heads_ok = cfg.n_heads == 0 or cfg.n_heads % m == 0
    if fits and not heads_ok:
        return "dp_replicated"
    return "tp2d"


def param_spec(path: tuple[str, ...], shape: tuple[int, ...], mesh: Grid,
               layout: str = "tp2d") -> tuple:
    if layout == "dp_replicated":
        return ()
    dp = dp_axes(mesh)

    def sub(s):
        return dp if s == "DP" else s

    for suffix, spec in _RULES:
        if _match(path, suffix):
            spec = tuple(sub(s) for s in spec)
            ndim = len(shape)
            if len(spec) > ndim:      # smoke configs may drop dims — bail
                return ()
            full = (None,) * (ndim - len(spec)) + spec
            # never shard a dim that isn't divisible by its axis size
            return tuple(
                None if ax is None or dim % _size(mesh, ax) else ax
                for dim, ax in zip(shape, full))
    return ()  # replicate 1-D / unmatched params


def leaves(tree, path=()):
    """(path, leaf) of a nested dict / list tree (a tuple is a leaf: a
    spec); list indices are left out of the path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (str(k),))
    elif isinstance(tree, list):
        for v in tree:
            yield from leaves(v, path)
    else:
        yield path, tree


def map_leaves(fn, tree, path=()):
    """The tree with every leaf replaced by fn(path, leaf)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v, path) for v in tree]
    return fn(path, tree)


def in_order_of(like, tree):
    """`tree` with its dict keys in `like`'s order: a tree carried
    across from the reference (`convert.lm_params_from_reference`)
    lists its top-level leaves in another order than `transformer.init`,
    and code that walks two trees leaf by leaf needs one order."""
    if isinstance(like, dict):
        return {k: in_order_of(v, tree[k]) for k, v in like.items()}
    if isinstance(like, list):
        return [in_order_of(v, t) for v, t in zip(like, tree)]
    return tree


def param_shardings(params_shape, mesh: Grid, layout: str = "tp2d"):
    """Tree of specs matching a param tree (tensors, on the `meta`
    device or not)."""
    return map_leaves(
        lambda p, v: param_spec(p, tuple(v.shape), mesh, layout),
        params_shape)


def opt_state_shardings(opt_shape, params_shardings, mesh: Grid):
    """m/v mirror the params; step is replicated."""
    return {"m": params_shardings, "v": params_shardings, "step": ()}


# ----------------------------------------------------------------- batch ---
def _largest_dividing_axes(axes: tuple, dim: int, mesh: Grid):
    """Longest prefix-shrunk axis tuple whose size product divides `dim`
    (the reference's rule: drop trailing axes until the product
    divides, so the batch stays sharded as widely as the shape
    allows)."""
    axes = tuple(axes)
    while axes:
        n = _size(mesh, axes)
        if dim % n == 0 and n > 1:
            return axes, n
        axes = axes[:-1]
    return None, 1


def batch_specs(batch_shape, mesh: Grid, layout: str = "tp2d"):
    """Shard every batch leaf over the widest dividing data-axis tuple
    (dim 0); with dp_replicated layout the model axis carries batch too."""
    dp = dp_axes(mesh)
    if layout == "dp_replicated":
        dp = tuple(mesh.axis_names)
    dp = dp if isinstance(dp, tuple) else (dp,)

    def spec(v):
        if not v.shape or v.shape[0] <= 1:
            return ()
        axes, _ = _largest_dividing_axes(dp, v.shape[0], mesh)
        if axes is None:
            return ()
        # a PartitionSpec entry of one axis is that axis' name
        return ((axes[0] if len(axes) == 1 else axes),) + (None,) * (
            len(v.shape) - 1)

    return {k: spec(v) for k, v in batch_shape.items()}


# -------------------------------------------------------------- KV cache ---
def _ndp(mesh: Grid) -> int:
    dp = dp_axes(mesh)
    return _size(mesh, dp) if dp is not None else 1


def choose_kv_spec(cfg, batch: int, seq: int, mesh: Grid) -> tuple:
    """Cache [..., B, S, K, hd]: shard B over DP when divisible; shard K
    over model when K % |model| == 0 (no softmax collectives), else S
    over model (flash-decoding: the partial softmaxes are combined by
    small all-reduces), else replicate."""
    dp = dp_axes(mesh)
    m = mesh.shape[MP]
    bspec = dp if batch % _ndp(mesh) == 0 and batch > 1 else None
    K = max(cfg.n_kv_heads, 1)
    if K % m == 0:
        return (bspec, None, MP, None)
    if seq % m == 0:
        return (bspec, MP, None, None)
    return (bspec, None, None, None)


def _cache_spec(cfg, shape, batch, seq, mesh: Grid) -> tuple:
    """The reference's spec of one stacked cache leaf."""
    ndim = len(shape)
    if ndim >= 5 and shape[-1] == cfg.head_dim and shape[-3] == seq:
        # [stack, B, S, K, hd]
        return (None,) * (ndim - 4) + choose_kv_spec(cfg, batch, seq, mesh)
    if ndim >= 5 and shape[-2] == seq:
        return ()
    # ssm states [stack, B, nh, hd, ds] / conv [stack, B, cw-1, cd]:
    # shard batch over DP; heads/channels over model when divisible
    dp, ndp = dp_axes(mesh), _ndp(mesh)
    parts = [None] * ndim
    if ndim >= 2 and shape[1] % ndp == 0 and shape[1] > 1:
        parts[1] = dp
    if ndim >= 3 and shape[2] % mesh.shape[MP] == 0:
        parts[2] = MP
    return tuple(parts)


def _cross_spec(shape, mesh: Grid) -> tuple:
    """The reference's spec of its cross_kv [L, 2, B, S, K, hd]."""
    parts = [None] * len(shape)
    if shape[2] % _ndp(mesh) == 0 and shape[2] > 1:
        parts[2] = dp_axes(mesh)
    if shape[3] % mesh.shape[MP] == 0:
        parts[3] = MP
    return tuple(parts)


def cache_shardings(cfg, cache_shape, batch: int, seq: int, mesh: Grid):
    """Specs of a decode cache tree (`transformer.init_cache`'s layout).
    Each per-layer leaf takes the reference's spec of its stacked leaf
    without the stack entries: a layer leaf is the reference's [stack,
    ...] leaf, a cross K or V leaf one [L, 2, ...] slice of its
    cross_kv."""
    out = {"layers": map_leaves(
        lambda _, v: _cache_spec(cfg, (1,) + tuple(v.shape), batch, seq,
                                 mesh)[1:],
        cache_shape["layers"])}
    if "cross_kv" in cache_shape:
        out["cross_kv"] = map_leaves(
            lambda _, v: _cross_spec((1, 2) + tuple(v.shape), mesh)[2:],
            cache_shape["cross_kv"])
    return out


# ============================================================ a rank's part
def batch_split(batch: int, mesh: Grid, layout: str = "tp2d"):
    """Which ranks split a batch of `batch` rows, as `batch_specs`
    shards it: "grid" (every rank its block: 'dp_replicated' where the
    grid's size divides the batch), "data" (each data index its block,
    the model ranks of one index the same rows) or None (every rank
    every row).  A split over a proper prefix of the DP axes (the
    production grid's "pod" alone) is left whole."""
    if batch <= 1:
        return None
    if layout == "dp_replicated" and mesh.size > 1 and batch % mesh.size == 0:
        return "grid"
    if mesh.data > 1 and batch % mesh.data == 0:
        return "data"
    return None


def local_batch(batch: int, mesh: Grid,
                layout: str = "tp2d") -> tuple[int, int]:
    """(first row, rows) of a batch of `batch` rows this rank holds:
    its block where `batch_split` splits the batch, else every row."""
    split = batch_split(batch, mesh, layout)
    if split is None:
        return 0, batch
    n, at = ((mesh.size, mesh.rank) if split == "grid"
             else (mesh.data, mesh.data_rank))
    rows = batch // n
    return at * rows, rows


def kv_layout(cfg, batch: int, seq: int, mesh: Grid,
              layout: str = "tp2d") -> str:
    """How the self-attention cache is split over the model axis:
    "heads", "seq" (a rank holds seq / M positions) or "whole", as
    `choose_kv_spec` says; "whole" under 'dp_replicated' (no collective
    runs over the model axis)."""
    if mesh.model == 1 or layout == "dp_replicated":
        return "whole"
    spec = choose_kv_spec(cfg, batch, seq, mesh)
    return "heads" if spec[2] == MP else "seq" if spec[1] == MP else "whole"


def heads_whole(cfg, mesh: Grid) -> bool:
    """Whether attention stays whole on every model rank: its query
    heads do not divide the model axis."""
    return cfg.n_heads > 0 and cfg.n_heads % mesh.model != 0


def _span(r: int, n: int, m: int, base: int = 0) -> torch.Tensor:
    step = n // m
    return torch.arange(base + r * step, base + (r + 1) * step)


def _need(what: str, n: int, m: int) -> None:
    if n % m:
        raise ValueError(f"a model axis of {m} does not divide {what} ({n})")


def partition(path: tuple[str, ...], shape: tuple[int, ...], cfg,
              mesh: Grid, layout: str = "tp2d"):
    """How a parameter leaf is split over the model axis in serving:
    None (every rank holds it whole) or (dim, idx) with idx(r) the
    indices along `dim` that model rank r holds.  Every leaf is whole
    under 'dp_replicated'; under 'tp2d' the attention leaves are whole
    where the query heads do not divide the model axis (`heads_whole`),
    and wk / wv where the KV heads do not.  Raises where a Mamba
    block's heads do not divide it: no config has both Mamba heads and
    attention heads the grids used here fail to divide, so no layout
    replicates a Mamba block."""
    m = mesh.model
    if m == 1 or layout == "dp_replicated":
        return None
    if "ssm" in path:
        return _mamba_partition(path[path.index("ssm") + 1:], shape, cfg, m)
    if _match(path, ("wq", "w")) or _match(path, ("wo", "w")):
        if heads_whole(cfg, mesh):
            return None
        dim = 1 if path[-2] == "wq" else 0
        return dim, lambda r: _span(r, shape[dim], m)
    if _match(path, ("wk", "w")) or _match(path, ("wv", "w")):
        if heads_whole(cfg, mesh) or cfg.n_kv_heads % m:
            return None
        return 1, lambda r: _span(r, shape[1], m)
    spec = param_spec(path, shape, mesh)
    if MP not in spec:
        return None
    dim = spec.index(MP)
    return dim, lambda r: _span(r, shape[dim], m)


def _mamba_partition(name: tuple, shape, cfg, m: int):
    """Head-aligned split of a Mamba block's leaf `name` (its path below
    "ssm")."""
    nh, di, ds = cfg.ssm_heads, cfg.d_inner, cfg.ssm_state
    _need("the Mamba heads", nh, m)

    def xs(r):                      # x's channels (and z's, the norm's)
        return _span(r, di, m)

    def channels(r):                # x's conv channels, then B and C
        return torch.cat([xs(r), torch.arange(di, di + 2 * ds)])

    key = name[0]
    if key == "in_proj":            # z | x | B | C | dt
        return 1, lambda r: torch.cat([
            xs(r), _span(r, di, m, di), torch.arange(2 * di, 2 * di + 2 * ds),
            _span(r, nh, m, 2 * di + 2 * ds)])
    if key == "conv_w":
        return 1, channels
    if key == "conv_b":
        return 0, channels
    if key in ("A_log", "D", "dt_bias"):
        return 0, lambda r: _span(r, nh, m)
    if key in ("norm", "out_proj"):
        return 0, xs
    raise KeyError(f"unknown Mamba leaf {name}")


# ====================================================== training (ZeRO-3)
def data_partition(path: tuple[str, ...], shape: tuple[int, ...],
                   mesh: Grid, layout: str = "tp2d"):
    """How a parameter leaf is split over the data axes in training:
    (dim, blocks), the dim `param_spec` gives the DP axes, cut into as
    many contiguous blocks as they have ranks (data rank d holds block
    d); None where the spec gives them no dim (1-D leaves, conv_w, a
    dim they do not divide, the 'dp_replicated' layout) or they have
    one rank."""
    dp = dp_axes(mesh)
    if dp is None or _size(mesh, dp) == 1:
        return None
    spec = param_spec(path, shape, mesh, layout)
    if dp not in spec:
        return None
    return spec.index(dp), _size(mesh, dp)


@dataclass(frozen=True)
class Piece:
    """What one rank holds of a parameter leaf (and of its gradient and
    AdamW moments) in training: `model` is `partition`'s (dim, idx) or
    None (whole over the model axis), `data` the dim of that model part
    whose `grid.data` contiguous blocks the data ranks hold (None:
    whole over the data axis), `shared` the (dim, lo, hi) slice of the
    model part that every model rank holds (a Mamba block's B/C
    columns) or None."""

    model: tuple[int, Callable] | None
    data: int | None
    shared: tuple[int, int, int] | None = None

    def cut(self, whole, grid: Grid):
        """`grid`'s rank's block of the whole leaf (a tensor, or a numpy
        array such as a checkpoint's memory-mapped leaf: only the
        block is read)."""
        t = whole
        if self.model is not None:
            dim, idx = self.model
            i = idx(grid.model_rank)
            t = (t.index_select(dim, i.to(t.device))
                 if isinstance(t, torch.Tensor)
                 else np.take(t, i.numpy(), axis=dim))
        if self.data is not None:
            n = t.shape[self.data] // grid.data
            at = [slice(None)] * t.ndim
            at[self.data] = slice(grid.data_rank * n, (grid.data_rank + 1) * n)
            t = t[tuple(at)]
        return t

    def counted(self, grid: Grid, block: torch.Tensor) -> torch.Tensor:
        """Σ x² over the elements of `block` (this rank's) that this rank
        counts in a global norm: each element of the whole leaf once,
        by the first of the ranks that hold it (model rank 0 for what
        every model rank holds, data rank 0 for what every data rank
        holds)."""
        zero = block.new_zeros((), dtype=torch.float32)
        if self.data is None and grid.data_rank != 0:
            return zero
        if self.model is None and grid.model_rank != 0:
            return zero
        sq = block.float().square()
        if self.shared is not None and grid.model_rank != 0:
            dim, lo, hi = self.shared
            sq.narrow(dim, lo, hi - lo).zero_()
        return sq.sum()


def train_piece(path: tuple[str, ...], shape: tuple[int, ...], cfg,
                mesh: Grid, layout: str = "tp2d") -> Piece:
    """A leaf's `Piece` of `mesh`'s ranks in training under `layout`
    (`Piece(None, None)` for every leaf under 'dp_replicated')."""
    model = partition(path, shape, cfg, mesh, layout)
    data = data_partition(path, shape, mesh, layout)
    shared = None
    if model is not None and "ssm" in path:
        shared = _mamba_shared(path[path.index("ssm") + 1], cfg, mesh.model)
    return Piece(model, None if data is None else data[0], shared)


def train_pieces(cfg, params_like, mesh: Grid, layout: str = "tp2d"):
    """Tree of `Piece`s matching a whole param tree (tensors, on the
    `meta` device or not)."""
    return map_leaves(
        lambda p, v: train_piece(p, tuple(v.shape), cfg, mesh, layout),
        params_like)


def _mamba_shared(key: str, cfg, m: int):
    """The B/C slice of a head-split Mamba leaf `key` (in the rank's
    part: z | x | B | C | dt for in_proj, x | B | C for conv)."""
    dil, ds = cfg.d_inner // m, cfg.ssm_state
    if key == "in_proj":
        return 1, 2 * dil, 2 * dil + 2 * ds
    if key == "conv_w":
        return 1, dil, dil + 2 * ds
    if key == "conv_b":
        return 0, dil, dil + 2 * ds
    return None
