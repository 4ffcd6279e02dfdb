"""Sharded training on a card: two ranks sharing one card (gloo, the
backend rule's choice) at a model axis of 2, each training its shard of
a smoke config in bf16 for 2 steps (batch 4 × 64, remat, lr 3e-4); the
ranks report the same losses, which lie within 2e-3 of one rank's run
of the whole model on the card (the reference's own meshes differ by up
to 3.6e-4 in bf16), and no step launches K4 (training attention is
plain).  qwen3-1.7b splits its vocabulary and KV heads; granite-moe
splits its experts and keeps its vocabulary whole.

The test carries the `cuda` marker and skips without a card.  This file
imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_tp_train.py
"""
import json
import os

import pytest
import torch
import torch.distributed as dist
from torch_ranks import init_rank, spawn_ranks

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch.mesh import gather, make_grid
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from repro_torch.train.data import DataConfig, SyntheticLM

WORLD = 2
ARCHS = ["qwen3-1.7b", "granite-moe-1b-a400m"]
B, S, STEPS = 4, 64, 2
BF16_TOL = 2e-3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sharded training on the card)")


def _train(cfg, dev, grid=None):
    """STEPS steps from seed 0's weights: (losses, K4 launches a step)."""
    step = TS.make_train_step(
        cfg, O.AdamWConfig(warmup_steps=5, total_steps=10),
        TS.TrainOptions(remat=True, q_chunk=0, loss_chunk=0), device=dev,
        grid=grid)
    params, state = TS.init_train_state(cfg, seed=0, device=dev, grid=grid)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B), cfg)
    losses, launched = [], []
    for s in range(STEPS):
        ops.reset_launches()
        params, state, m = step(params, state, data.batch(s))
        losses.append(float(m["loss"]))
        launched.append(ops.launches["flash"])
    return losses, launched


def _card_rank(rank, world, rdv, out_dir):
    group, dev = init_rank(rank, world, rdv, device="cuda")
    grid = make_grid(model=WORLD)
    out = {"backend": dist.get_backend(group)}
    for arch in ARCHS:
        losses, launched = _train(configs.get_smoke_config(arch), dev, grid)
        out[arch] = {"losses": gather(group, losses), "launches": launched}
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


@pytest.mark.cuda
def test_two_ranks_on_one_card_train_like_one(tmp_path):
    _need_card()
    spawn_ranks(_card_rank, WORLD, tmp_path, str(tmp_path))
    recs = [json.loads((tmp_path / f"r{r}.json").read_text())
            for r in range(WORLD)]
    assert all(r["backend"] == "gloo" for r in recs)
    for arch in ARCHS:
        want, launched = _train(configs.get_smoke_config(arch),
                                torch.device("cuda"))
        assert launched == [0] * STEPS
        for r in recs:
            assert r[arch]["launches"] == [0] * STEPS, (arch, r[arch])
            every = r[arch]["losses"]
            assert all(x == every[0] for x in every), (arch, every)
            got = every[0]
            assert all(abs(a - b) <= BF16_TOL for a, b in zip(got, want)), (
                arch, got, want)
