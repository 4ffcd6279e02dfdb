"""LM training on a card: the reduced qwen3 and granite-moe configs'
loss and gradients (bf16 compute, fp32 masters) on the card against the
same weights and batch on the CPU, one `make_train_step` step on both,
and the launcher's resume on the card under deterministic algorithms.
Training launches no kernel of the port (K4 is forward-only), so K4's
counter stays 0.

The tests carry the `cuda` marker and skip without a card.  This file
imports neither JAX nor the reference package, so it also runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch.train import main as train_main
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.tree import leaves, tree_map

ARCHS = ["qwen3-1.7b", "granite-moe-1b-a400m"]
TOL = 5e-2          # bf16 compute on two devices (the CPU tests' bf16 limit)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _batch(cfg, B=2, S=64):
    return SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                  seed=5), cfg).batch(0)


def _loss_grads(cfg, params, batch):
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, _ = T.loss_fn(cfg, remat=True)(params, batch)
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                                  for p, g in zip(ps, gs)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_on_card_equal_cpu(arch):
    _need_card()
    cfg = configs.get_smoke_config(arch)
    cpu = T.init(cfg, 0)
    card = tree_map(lambda t: t.to("cuda"), cpu)
    batch = _batch(cfg)
    ops.reset_launches()
    cl, cg = _loss_grads(cfg, cpu, batch)
    gl, gg = _loss_grads(cfg, card, {k: v.cuda() for k, v in batch.items()})
    assert ops.launches["flash"] == 0
    assert np.isfinite(gl)
    np.testing.assert_allclose(gl, cl, atol=TOL, rtol=TOL)
    for a, b in zip(gg, cg):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   b.float().numpy(), atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_card_equals_cpu(arch):
    """One AdamW step (lr 1e-3) from the same state: loss, grad norm and
    the updated params within the bf16 tolerance."""
    _need_card()
    cfg = configs.get_smoke_config(arch)
    opt = O.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    out = {}
    for dev in ("cpu", "cuda"):
        params, state = TS.init_train_state(cfg, seed=0, device="cpu")
        params = tree_map(lambda t: t.to(dev), params)
        state = tree_map(lambda t: t.to(dev), state)
        step = TS.make_train_step(cfg, opt, TS.TrainOptions(), device=dev)
        params, state, m = step(params, state, _batch(cfg))
        out[dev] = (params, {k: float(v) for k, v in m.items()})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(out["cuda"][1][k], out["cpu"][1][k],
                                   atol=TOL, rtol=TOL, err_msg=k)
    for a, b in zip(leaves(out["cuda"][0]), leaves(out["cpu"][0])):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().numpy(), atol=TOL, rtol=TOL)


@pytest.mark.cuda
def test_resume_on_card_continues_stream(tmp_path):
    """4 + 4 steps against 8 on the card, under deterministic algorithms,
    within the reference's own tolerance (rtol 2e-5 / atol 2e-6)."""
    _need_card()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    common = ["--arch", "qwen3-1.7b", "--smoke", "--batch", "2", "--seq",
              "16", "--log-every", "100", "--device", "cuda"]
    torch.use_deterministic_algorithms(True)
    try:
        d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
        for steps in ("4", "8"):
            train_main(common + ["--steps", steps, "--ckpt-dir", d1,
                                 "--ckpt-every", "4"])
        train_main(common + ["--steps", "8", "--ckpt-dir", d2,
                             "--ckpt-every", "8"])
    finally:
        torch.use_deterministic_algorithms(False)

    def saved(d):
        man = json.load(open(os.path.join(d, "step_8", "manifest.json")))
        return {m["path"]: np.load(os.path.join(d, "step_8", m["file"]))
                for m in man["leaves"]}

    l1, l2 = saved(d1), saved(d2)
    assert l1.keys() == l2.keys()
    for k in l1:
        np.testing.assert_allclose(l1[k], l2[k], rtol=2e-5, atol=2e-6,
                                   err_msg=k)
