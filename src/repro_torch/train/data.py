"""Deterministic, resumable data pipeline.

Counterpart of `repro/train/data.py`.  batch(step) is a pure function
of (seed, step): resuming from a checkpoint at step k reproduces the
exact stream with no iterator state to persist, and the stream is the
same whatever device trains on it.  Batches are CPU tensors (tokens and
labels int32, frame and patch embeddings bfloat16, as
`configs.input_specs` describes them); the trainer moves them to its
device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """Zipf-ish synthetic tokens (uniform is adversarially easy to fit):
    u ~ U[1e-6, 1) in fp32, token ⌊u³·V⌋ clipped to [0, V), labels the
    next tokens.  The draws come from `np.random.default_rng([seed,
    step])`, so the tokens differ from the reference's (`jax.random`),
    as `models.transformer.init`'s weights do; the distribution and the
    batch layout are the reference's.  encdec batches add "enc_embeds"
    and vlm batches are {"embeds", "positions3", "labels"}, normal
    draws in bfloat16."""

    def __init__(self, cfg: DataConfig, model_cfg=None):
        self.cfg = cfg
        self.model_cfg = model_cfg

    def batch(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng([c.seed, step])
        u = rng.uniform(1e-6, 1.0, (c.global_batch, c.seq_len + 1)).astype(
            np.float32)
        toks = np.clip((np.power(u, np.float32(3.0)) * np.float32(c.vocab))
                       .astype(np.int32), 0, c.vocab - 1)
        toks = torch.from_numpy(toks)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        mc = self.model_cfg

        def embeds():
            x = rng.standard_normal((c.global_batch, c.seq_len, mc.d_model),
                                    dtype=np.float32)
            return torch.from_numpy(x).to(torch.bfloat16)

        if mc is not None and mc.family == "encdec":
            batch["enc_embeds"] = embeds()
        if mc is not None and mc.family == "vlm" and mc.stub_frontend:
            pos = torch.arange(c.seq_len, dtype=torch.int32)
            batch = {"embeds": embeds(),
                     "positions3": pos.expand(c.global_batch, 3, c.seq_len),
                     "labels": batch["labels"]}
        return batch


class TokenFile:
    """Memmap token corpus: deterministic strided windows by step (the
    reference's numpy draws, so its batches on the same file)."""

    def __init__(self, path: str, cfg: DataConfig, dtype=np.uint16):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=dtype, mode="r")

    def batch(self, step: int) -> dict:
        c = self.cfg
        n_win = (len(self.data) - 1) // c.seq_len
        rng = np.random.default_rng(c.seed + step)
        idx = rng.integers(0, n_win, size=c.global_batch)
        tok = np.stack(
            [self.data[i * c.seq_len: i * c.seq_len + c.seq_len + 1]
             for i in idx]
        ).astype(np.int32)
        return {"tokens": torch.from_numpy(tok[:, :-1].copy()),
                "labels": torch.from_numpy(tok[:, 1:].copy())}
