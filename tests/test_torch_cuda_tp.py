"""Tensor-parallel serving on a card: two ranks sharing one card (gloo,
the backend rule's choice) at a model axis of 2, each running its shard
of a smoke config in bf16 with a 512-token prompt (so prefill attention
takes K4) and 2 decode steps; every rank launches K4 once per
flash-eligible call, all of the wgmma kernel, the ranks take the same
tokens, and the TP logits lie within the repo's bf16 tolerance of one
rank's run of the whole model on the card (first tokens equal where
one device's top-2 gap exceeds the distance).  qwen3-1.7b splits its KV
heads; granite-34b's one KV head puts the decode cache's sequence over
the model axis.

The test carries the `cuda` marker and skips without a card.  This file
imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_tp.py
"""
import json
import os

import pytest
import torch
import torch.distributed as dist
from torch_ranks import init_rank, spawn_ranks

from repro_torch import configs
from repro_torch.convert import shard_params
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import ops
from repro_torch.launch.mesh import gather, make_grid
from repro_torch.models import transformer as T
from repro_torch.parallel.sharding import kv_layout
from repro_torch.serve.serve_step import (cast_params_for_serving,
                                          make_decode, make_prefill)
from repro_torch.serve.session import fake_prompts, seed_cache

WORLD = 2
ARCHS = ["qwen3-1.7b", "granite-34b"]
B, S, GEN = 2, 512, 2
BF16_TOL = 5e-2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K4 is CUDA C++; no CPU mode)")


def _serve(cfg, params, grid, dev):
    """Prefill and GEN greedy steps; (prefill logits, tokens, K4
    launches and kernels of the prefill)."""
    batch = fake_prompts(cfg, B, S, seed=0, device=dev)
    ops.reset_launches()
    logits, pc = make_prefill(cfg, dev, q_chunk=0, grid=grid)(params, batch)
    torch.cuda.synchronize(dev)
    launched = (ops.launches["flash"], dict(k4.variant_launches))
    cache = T.init_cache(cfg, B, S + GEN, device=dev, grid=grid)
    off = 0
    if grid is not None and kv_layout(cfg, B, S + GEN, grid) == "seq":
        off = grid.model_rank * ((S + GEN) // grid.model)
    seed_cache(cache, pc, S, off)
    decode = make_decode(cfg, dev, grid=grid, batch=B, max_seq=S + GEN)
    tok = logits.argmax(-1)[:, None]
    tokens = [tok[:, 0].tolist()]
    for i in range(GEN):
        lg, cache = decode(params, tok, cache, S + i)
        tok = lg.argmax(-1)[:, None]
        tokens.append(tok[:, 0].tolist())
    return logits.float().cpu(), tokens, launched


def _params(cfg, dev, grid=None):
    return T.init(cfg, 0, dev, cast=cast_params_for_serving,
                  shard=None if grid is None else (
                      lambda part: shard_params(part, cfg, grid)))


def _card_rank(rank, world, rdv, out_dir):
    group, dev = init_rank(rank, world, rdv, device="cuda")
    grid = make_grid(model=WORLD)
    out = {"backend": dist.get_backend(group)}
    with torch.inference_mode():
        for arch in ARCHS:
            cfg = configs.get_smoke_config(arch)
            logits, tokens, launched = _serve(cfg, _params(cfg, dev, grid),
                                              grid, dev)
            out[arch] = {"tokens": gather(group, tokens),
                         "launches": launched}
            if rank == 0:
                torch.save(logits, os.path.join(out_dir, f"{arch}.pt"))
    with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


@pytest.mark.cuda
def test_two_ranks_on_one_card_serve_like_one(tmp_path):
    _need_card()
    ops.prepare_flash(torch.device("cuda"))     # the ranks load this build
    spawn_ranks(_card_rank, WORLD, tmp_path, str(tmp_path))
    recs = [json.loads((tmp_path / f"r{r}.json").read_text())
            for r in range(WORLD)]
    assert all(r["backend"] == "gloo" for r in recs)
    for arch in ARCHS:
        cfg = configs.get_smoke_config(arch)
        with torch.inference_mode():
            want, want_tokens, _ = _serve(cfg, _params(cfg, "cuda"), None,
                                          torch.device("cuda"))
        want_k4 = T.flash_calls(cfg)
        for r in recs:
            n, variants = r[arch]["launches"]
            assert n == want_k4, (arch, n)
            assert variants == {"scalar": 0, "wgmma": want_k4}, variants
            toks = r[arch]["tokens"]
            assert all(t == toks[0] for t in toks), (arch, toks)
        got = torch.load(tmp_path / f"{arch}.pt")
        assert torch.isfinite(got).all()
        dist_ = float((got - want).abs().max())
        assert dist_ <= BF16_TOL, (arch, dist_)
        # a row's first token may differ only where one device's top-2
        # gap is within the distance
        top = want.topk(2, dim=-1).values
        for b, gap in enumerate((top[:, 0] - top[:, 1]).tolist()):
            if gap > dist_:
                assert recs[0][arch]["tokens"][0][0][b] == want_tokens[0][b]
