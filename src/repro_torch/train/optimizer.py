"""AdamW (decoupled weight decay), its LR schedule and global-norm
clipping, over trees of tensors (nested dicts and lists).

Counterpart of `repro/train/optimizer.py`, with its arithmetic: the
gradients are clipped by min(1, clip / (‖g‖ + 1e-9)), the moments and
bias corrections are fp32, and the decay `lr·wd·p` is applied to every
leaf (norms and embeddings too).  `torch.optim.AdamW` differs (no
global clip, another decay form), so it is not used.  The update runs
in place under `torch.no_grad()`, the counterpart of the reference's
donated buffers: the new parameter is cast back to the parameter's
dtype and written into it; `m`, `v` and `step` (int32) likewise.

Under a grid (`train_step.make_train_step(..., grid=)`) the update runs
elementwise on each rank's block of every leaf and its moments; only
the global norm needs the other ranks (`global_norm(..., pieces=,
grid=)`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .tree import leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to `min_lr_ratio`; an fp32
    scalar tensor for a step given as an int or a tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def init_opt_state(params) -> dict:
    """Zeroed fp32 moments like `params` and an int32 step of 0."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    first = leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree, *, pieces=None, grid=None) -> torch.Tensor:
    """√(Σ x²) over every leaf, in fp32 (leaves summed one after another,
    as the reference's Python `sum`).

    With `pieces` (a tree of `sharding.Piece` like `tree`) and `grid`,
    `tree` holds this rank's blocks and the norm is the whole tree's:
    each rank sums the squares of the elements it counts
    (`Piece.counted`: each element once, though several ranks hold
    it), and the sums are added over the model and the data axes."""
    if pieces is None:
        return torch.sqrt(sum(x.float().square().sum()
                              for x in leaves(tree)))
    import torch.distributed as dist

    total = sum(p.counted(grid, x) for p, x in zip(leaves(pieces),
                                                   leaves(tree)))
    for group in (grid.model_group, grid.data_group):
        if dist.get_world_size(group) > 1:
            total = _summed(total, group)
    return torch.sqrt(total)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """A scalar summed over `group` (through the host under gloo; in
    place under any other backend, the dry-run's `fake` group on `meta`
    tensors too)."""
    import torch.distributed as dist

    y = x.detach().reshape(1).to(
        "cpu" if dist.get_backend(group) == "gloo" else x.device,
        torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y[0].to(x.device)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params, *,
                 gnorm=None):
    """One AdamW step written into `params` and `opt_state` in place.
    Returns (params, opt_state, {"grad_norm", "lr"}), the metrics as
    fp32 scalar tensors (no host synchronization).  `gnorm`: the
    gradients' global norm where the caller computed it (a sharded
    step), else `global_norm(grads)`."""
    step = opt_state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step).to(gnorm.device)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(opt_state["m"]), leaves(opt_state["v"])):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        p32 = p.float()
        new_p = p32 - lr * ((m / bc1) / ((v / bc2).sqrt() + cfg.eps)
                            + cfg.weight_decay * p32)
        p.copy_(new_p)
    opt_state["step"].copy_(step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
