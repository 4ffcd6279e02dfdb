"""Port parity, LM training's optimizer and train step:
`train/optimizer.py` (`lr_at`, `global_norm`, `adamw_update`,
`init_opt_state`) and `train/train_step.py` (`make_train_step` with
remat and accumulation, `_needs_chunk`), against the reference package
on the CPU.

Weights are the reference's smoke weights from seed 0 carried across
with `convert.lm_params_from_reference`, its optimizer state with
`convert.opt_state_from_reference`; batches are the port's
`SyntheticLM` draws as numpy, fed to both packages.  Tolerances: one
AdamW update within 1e-6 relative; four train steps (and an
accumulated one) within 1e-4 (float32).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_families import _ref_tree
from test_torch_train import _cfgs, _flat, _to_port, _to_ref, _trees_close

from repro.compat import set_mesh
from repro.launch.mesh import make_host_mesh
from repro.train import optimizer as RO
from repro.train import train_step as RTS

from repro_torch import configs
from repro_torch.convert import (lm_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from repro_torch.train.data import DataConfig, SyntheticLM

torch.set_num_threads(1)


# ------------------------------------------------------------ optimizer ---
OPT = dict(lr=1e-2, warmup_steps=4, total_steps=20, weight_decay=0.1,
           grad_clip=1.0)


@pytest.mark.parametrize("step", [0, 1, 4, 12, 20, 27])
def test_lr_at_matches_reference(step):
    rcfg, pcfg = RO.AdamWConfig(**OPT), O.AdamWConfig(**OPT)
    want = float(RO.lr_at(rcfg, jnp.asarray(step, jnp.int32)))
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        got = O.lr_at(pcfg, s)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-7)


def test_global_norm_matches_reference():
    tree = _ref_tree("granite-moe-1b-a400m", 0)
    want = float(RO.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = O.global_norm(lm_params_from_reference(tree))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_adamw_update_matches_reference(clip):
    """One update from a state three steps in (nonzero moments), carried
    across with `opt_state_from_reference`: params, moments, step and
    metrics within 1e-6 relative."""
    rng = np.random.default_rng(5)
    tree = _ref_tree("qwen3-1.7b", 0)
    grads = jax.tree.map(
        lambda a: (rng.normal(size=a.shape) * 0.05).astype(np.float32), tree)
    cfg = dict(OPT, grad_clip=clip)
    rcfg, pcfg = RO.AdamWConfig(**cfg), O.AdamWConfig(**cfg)
    update = jax.jit(functools.partial(RO.adamw_update, rcfg))
    rp = jax.tree.map(jnp.asarray, tree)
    rs = RO.init_opt_state(rp)
    for i in range(3):
        g = jax.tree.map(lambda a, i=i: jnp.asarray(a * (1 + i)), grads)
        rp, rs, _ = update(g, rs, rp)
    rp_np = jax.tree.map(np.asarray, rp)
    rs_np = jax.tree.map(np.asarray, rs)
    g = jax.tree.map(jnp.asarray, grads)
    rp2, rs2, rm = update(g, rs, rp)

    pp = lm_params_from_reference(rp_np)
    ps = opt_state_from_reference(rs_np)
    assert ps["step"].dtype == torch.int32 and int(ps["step"]) == 3
    pg = lm_params_from_reference(grads)
    out_p, out_s, pm = O.adamw_update(pcfg, pg, ps, pp)
    assert out_p is pp and out_s is ps             # updated in place
    tol = dict(atol=0, rtol=1e-6)
    _trees_close(pp, lm_params_from_reference(jax.tree.map(np.asarray, rp2)),
                 atol=1e-8, rtol=1e-6)
    for k in ("m", "v"):
        _trees_close(ps[k], lm_params_from_reference(
            jax.tree.map(np.asarray, rs2[k])), atol=1e-12, rtol=1e-6)
    assert int(ps["step"]) == int(rs2["step"]) == 4
    assert ps["step"].dtype == torch.int32
    np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]),
                               **tol)
    np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]), **tol)
    for k, m in _flat(ps["m"]).items():
        assert m.dtype == torch.float32, k


def test_init_opt_state_layout():
    params = lm_params_from_reference(_ref_tree("whisper-base", 0))
    st = O.init_opt_state(params)
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    for k in ("m", "v"):
        f = _flat(st[k])
        assert f.keys() == _flat(params).keys()
        assert all(t.dtype == torch.float32 and not t.any()
                   for t in f.values())


# ----------------------------------------------------------- train step ---
def _synthetic(cfg, B, S, steps):
    """The port's SyntheticLM batches as numpy, fed to both packages."""
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                  seed=3), cfg)
    return [{k: v.numpy() for k, v in data.batch(s).items()}
            for s in range(steps)]


def _ref_steps(rcfg, opts, batches, opt_cfg):
    mesh = make_host_mesh(model=1)
    with set_mesh(mesh):
        first = _to_ref(batches[0], jnp.float32)
        step, _, _, _ = RTS.make_train_step(
            rcfg, opt_cfg, mesh, opts,
            jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                         first))
        params = jax.tree.map(jnp.asarray, _ref_tree(rcfg.name, 0))
        state = RO.init_opt_state(params)
        out = []
        for b in batches:
            params, state, m = step(params, state, _to_ref(b, jnp.float32))
            out.append({k: float(v) for k, v in m.items()})
        return out, jax.tree.map(np.asarray, params)


def _port_steps(pcfg, opts, batches, opt_cfg):
    step = TS.make_train_step(pcfg, opt_cfg, opts, device="cpu")
    params = lm_params_from_reference(_ref_tree(pcfg.name, 0))
    state = O.init_opt_state(params)
    out = []
    for b in batches:
        params, state, m = step(params, state, _to_port(b, torch.float32))
        out.append({k: float(v) for k, v in m.items()})
    return out, params


@pytest.mark.parametrize("arch,accum,steps", [
    ("qwen3-1.7b", 1, 4), ("granite-moe-1b-a400m", 1, 4),
    ("qwen3-1.7b", 2, 2)], ids=["qwen3", "granite-moe", "qwen3-accum2"])
def test_train_steps_match_reference(arch, accum, steps):
    """`make_train_step` (remat on, AdamW) against the reference's on a
    one-device mesh, on the same batches from the same weights: each
    step's loss, grad norm and lr, and the params after the last step,
    within 1e-4.  With accum_steps=2 the batch of 4 splits into two
    microbatches; `tokens` is then 0 in both packages."""
    rcfg, pcfg = _cfgs(arch)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=8)
    opts = dict(remat=True, q_chunk=0, loss_chunk=0, accum_steps=accum)
    batches = _synthetic(pcfg, 4, 16, steps)
    rm, rp = _ref_steps(rcfg, RTS.TrainOptions(**opts), batches,
                        RO.AdamWConfig(**opt))
    pm, pp = _port_steps(pcfg, TS.TrainOptions(**opts), batches,
                         O.AdamWConfig(**opt))
    for r, p in zip(rm, pm):
        assert r.keys() == p.keys()
        for k in r:
            np.testing.assert_allclose(p[k], r[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        assert p["tokens"] == r["tokens"] == (0.0 if accum > 1 else 64.0)
    _trees_close(pp, lm_params_from_reference(rp), atol=1e-4, rtol=1e-4)


def test_needs_chunk_rule():
    opts = TS.TrainOptions(q_chunk=8)
    spec = configs.input_specs(configs.get_smoke_config("qwen3-1.7b"),
                               configs.ShapeConfig("t", 16, 2, "train"))
    assert TS._needs_chunk(None, spec, opts)
    spec = configs.input_specs(configs.get_smoke_config("qwen2-vl-72b"),
                               configs.ShapeConfig("t", 15, 2, "train"))
    assert not TS._needs_chunk(None, spec, opts)
    assert not TS._needs_chunk(None, spec, TS.TrainOptions(q_chunk=0))


def test_cuda_without_a_card_raises():
    cfg = configs.get_smoke_config("qwen3-1.7b")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.make_train_step(cfg, O.AdamWConfig(), TS.TrainOptions())
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.init_train_state(cfg)
