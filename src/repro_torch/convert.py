"""Carry the reference's state across: graphs, plans and LM weights.

Graphs and plans play the part that weights play in a model.  Every
helper takes plain numpy arrays / JSON-able dicts — what the reference
package's `GraphCSR` fields, `plan_to_dict` records and params pytrees
are once converted with `np.asarray` — so nothing here imports the
reference.  The LM mapping takes any tree in the params' layout: weights,
their gradients, and the optimizer's moments.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.plan import MatchingPlan, plan_from_dict
from .graph.csr import GraphCSR
from .parallel.sharding import in_order_of, leaves, map_leaves, partition


def graph_from_arrays(indptr, indices, degrees, labels=None, *,
                      name: str = "") -> GraphCSR:
    """The port's GraphCSR over the reference's CSR arrays (indptr
    [n+1], sentinel-padded indices, degrees [n], optional labels [n]).
    The arrays are copied as int32, so the fingerprint matches the
    reference's for the same graph."""
    indptr = np.array(indptr, dtype=np.int32)
    indices = np.array(indices, dtype=np.int32)
    degrees = np.array(degrees, dtype=np.int32)
    n = len(indptr) - 1
    if degrees.shape != (n,):
        raise ValueError(f"degrees shape {degrees.shape} != ({n},)")
    if not np.array_equal(np.diff(indptr), degrees):
        raise ValueError("degrees disagree with indptr")
    if len(indices) < int(indptr[-1]):
        raise ValueError("indices shorter than indptr[-1]")
    if labels is not None:
        labels = np.array(labels, dtype=np.int32)
        if labels.shape != (n,):
            raise ValueError(f"labels shape {labels.shape} != ({n},)")
    return GraphCSR(n=n, m=int(indptr[-1]) // 2, indptr=indptr,
                    indices=indices, degrees=degrees, name=name,
                    labels=labels)


def plan_from_reference(d: dict) -> MatchingPlan:
    """A port MatchingPlan from the reference's `plan_to_dict` record
    (the record format is shared, so this is `plan_from_dict`)."""
    return plan_from_dict(d)


def lm_params_from_reference(tree: dict, *, device="cpu") -> dict:
    """The port's LM params (`models/transformer.py` layout) from the
    reference's params pytree with numpy leaves, for every family.

    The reference stacks its layers for `lax.scan`: every leaf under
    `blocks/l<j>/...` has a leading [n_blocks] axis (block b, position j
    is layer b·block_len + j; jamba's superblock holds 8 layers), and
    every leaf under `encoder` / `cross` (encdec) a leading [enc_layers]
    / [n_layers] axis.  The port keeps one dict per layer, so each
    stacked leaf is split along that axis (an MoE leaf [n_blocks, E, d,
    ff] becomes [E, d, ff] per layer); the rest (embed, final_norm,
    lm_head, enc_final_norm) maps one to one.  Leaves become fp32
    tensors on `device`."""
    def leaf(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    def walk(node, pick=None):
        if isinstance(node, dict):
            return {k: walk(v, pick) for k, v in node.items()}
        return leaf(node if pick is None else np.asarray(node)[pick])

    def depth(node):
        while isinstance(node, dict):
            node = next(iter(node.values()))
        return np.asarray(node).shape[0]

    blocks = tree["blocks"]
    blk = len(blocks)                   # layers per block: l0 .. l<blk-1>
    n_blocks = depth(blocks["l0"])
    out = {k: walk(v) for k, v in tree.items()
           if k not in ("blocks", "encoder", "cross")}
    out["layers"] = [walk(blocks[f"l{i % blk}"], i // blk)
                     for i in range(n_blocks * blk)]
    for k in ("encoder", "cross"):
        if k in tree:
            out[k] = [walk(tree[k], i) for i in range(depth(tree[k]))]
    return out


def opt_state_from_reference(state: dict, *, device="cpu") -> dict:
    """The port's AdamW state (`train/optimizer.py`) from the
    reference's {"m", "v", "step"} with numpy leaves: the moments go
    through `lm_params_from_reference`'s mapping (they mirror the
    params), the step becomes an int32 scalar tensor."""
    return {"m": lm_params_from_reference(state["m"], device=device),
            "v": lm_params_from_reference(state["v"], device=device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def shard_params(tree: dict, cfg, grid, *, model_rank: int | None = None,
                 data_rank: int | None = None, zero: bool = False,
                 layout: str | None = None):
    """A rank's shard of a whole LM param tree (`models/transformer.py`
    layout; fp32 masters or cast for serving) under `layout` (default
    `sharding.pick_layout`'s): each leaf that
    `parallel.sharding.partition` splits over the model axis keeps the
    indices of model rank `model_rank` (default: `grid`'s own), the
    others are kept whole (every leaf under 'dp_replicated').  With
    `zero` (training), each leaf then keeps the block of data rank
    `data_rank` (default: `grid`'s own) along the dim
    `sharding.data_partition` names: the rank's `sharding.Piece`.
    Works on the parts `transformer.init` draws one at a time too
    ({"embed": ...}, {"layers": [...]}), and on the AdamW moments,
    which mirror the params."""
    from .parallel.sharding import pick_layout, train_piece

    g = _at(grid, model_rank, data_rank)
    layout = layout or pick_layout(cfg, grid)

    def one(path, leaf):
        if zero:
            return train_piece(path, tuple(leaf.shape), cfg, g, layout).cut(
                leaf, g).contiguous()
        cut = partition(path, tuple(leaf.shape), cfg, g, layout)
        if cut is None:
            return leaf
        dim, idx = cut
        return leaf.index_select(dim, idx(g.model_rank).to(leaf.device))

    return map_leaves(one, tree)


def _at(grid, model_rank, data_rank):
    """`grid` seen from the rank at (data_rank, model_rank) (None: the
    grid's own)."""
    from dataclasses import replace

    m = grid.model_rank if model_rank is None else model_rank
    d = grid.data_rank if data_rank is None else data_rank
    return replace(grid, rank=d * grid.model + m)


def gather_params(shards: list, cfg, grid, *, zero: bool = False,
                  layout: str | None = None) -> dict:
    """The whole tree from every rank's shard: the inverse of
    `shard_params` (same `layout`).  `shards[r]` is model rank r's, or
    with `zero` the shard of rank r = data rank · model + model rank
    (every rank of the grid)."""
    from .models.transformer import init
    from .parallel.sharding import pick_layout, train_piece

    layout = layout or pick_layout(cfg, grid)
    like = init(cfg, device="meta")
    flat = [[leaf for _, leaf in leaves(in_order_of(like, s))]
            for s in shards]
    at = iter(range(len(flat[0])))

    def one(path, whole):
        i = next(at)
        parts = [f[i] for f in flat]
        if zero:
            pieces = [train_piece(path, tuple(whole.shape), cfg,
                                  _at(grid, r % grid.model, r // grid.model),
                                  layout)
                      for r in range(len(parts))]
            return _assemble(whole, parts, pieces, grid)
        cut = partition(path, tuple(whole.shape), cfg, grid, layout)
        if cut is None:
            return parts[0]
        dim, idx = cut
        out = parts[0].new_empty(whole.shape)
        for r, part in enumerate(parts):
            out.index_copy_(dim, idx(r).to(part.device), part)
        return out

    return map_leaves(one, like)


def _assemble(whole, parts, pieces, grid):
    """The whole leaf from every rank's block (`parts[r]`, laid out by
    `pieces[r]`), written rank after rank through its model part."""
    out = parts[0].new_zeros(whole.shape)
    for r, (part, piece) in enumerate(zip(parts, pieces)):
        g = _at(grid, r % grid.model, r // grid.model)
        mine, model_part = None, out
        if piece.model is not None:
            dim, idx = piece.model
            mine = idx(g.model_rank).to(out.device)
            model_part = out.index_select(dim, mine)
        target = model_part
        if piece.data is not None:
            n = part.shape[piece.data]
            target = model_part.narrow(piece.data, g.data_rank * n, n)
        target.copy_(part)
        if mine is not None:
            out.index_copy_(dim, mine, model_part)
    return out
