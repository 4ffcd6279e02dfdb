"""Port parity, LM training's loss: `models.transformer.loss_fn` (with
`_xent`, remat, query-chunked attention and the chunked loss) for every
family, and `configs.input_specs`, against the reference package on the
CPU.  The optimizer and the train step are in
tests/test_torch_train_step.py, which shares the helpers here.

Weights are the reference's smoke weights from seed 0 carried across
with `convert.lm_params_from_reference`; the reference's gradients go
through the same mapping.  Batches are numpy arrays from a seed, the
same for both packages.  Tolerances: the loss within rtol 1e-5 and
every gradient leaf within atol 1e-5 / rtol 1e-4 in float32 (sums in
another order), 5e-2 in bf16 (the reference's own bf16 tolerance between
its decode and prefill paths).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm_families import _batch, _ref_tree

from repro import configs as ref_configs
from repro.models import transformer as RT

from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import transformer as T
from repro_torch.train import train_step as TS

torch.set_num_threads(1)

ARCHS = ["qwen3-1.7b", "granite-moe-1b-a400m", "mamba2-370m",
         "jamba-v0.1-52b", "whisper-base", "qwen2-vl-72b"]


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (ref_configs.get_smoke_config(arch).scaled(**kw),
            configs.get_smoke_config(arch).scaled(**kw))


def _seq(arch):
    """Two SSD chunks of the smoke configs (16 tokens each); one for
    jamba's 8-layer stack."""
    return 16 if arch == "jamba-v0.1-52b" else 32


def _train_batch(cfg, B, S, seed=1, masked=0):
    """`_batch`'s prompts plus labels; the first `masked` labels of each
    row are −1."""
    batch = _batch(cfg, B, S, seed)
    labels = np.random.default_rng(seed + 100).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)
    labels[:, :masked] = -1
    batch["labels"] = labels
    return batch


def _to_ref(batch, dtype):
    return {k: jnp.asarray(v) if v.dtype == np.int32
            else jnp.asarray(v, dtype) for k, v in batch.items()}


def _to_port(batch, dtype):
    return {k: torch.from_numpy(v) if v.dtype == np.int32
            else torch.from_numpy(v).to(dtype) for k, v in batch.items()}


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _trees_close(got, want, atol, rtol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in g:
        assert tuple(g[k].shape) == tuple(w[k].shape), k
        np.testing.assert_allclose(_np(g[k]), _np(w[k]), atol=atol,
                                   rtol=rtol, err_msg=k)


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(arch, dtype="float32", masked=0, **kw):
    """The reference's loss, token count and gradients (the port's
    layout, numpy) on `arch`'s smoke weights and `_train_batch`."""
    rcfg, _ = _cfgs(arch, dtype=dtype)
    rp = jax.tree.map(jnp.asarray, _ref_tree(arch, 0))
    batch = _to_ref(_train_batch(rcfg, 2, _seq(arch), masked=masked),
                    getattr(jnp, dtype))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        RT.loss_fn(rcfg, **kw), has_aux=True))(rp, batch)
    return (float(loss), float(metrics["tokens"]),
            lm_params_from_reference(jax.tree.map(np.asarray, grads)))


def _port_loss_grads(arch, dtype="float32", masked=0, **kw):
    _, pcfg = _cfgs(arch, dtype=dtype)
    params = lm_params_from_reference(_ref_tree(arch, 0))
    batch = _to_port(_train_batch(pcfg, 2, _seq(arch), masked=masked),
                     getattr(torch, dtype))
    loss, metrics, grads = TS._grads(T.loss_fn(pcfg, **kw), params, batch)
    return float(loss), float(metrics["tokens"]), grads


# ----------------------------------------------------------------- loss ---
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Every family's smoke config in float32: the loss, the count of
    labels and every gradient leaf."""
    rl, rn, rg = _ref_loss_grads(arch)
    pl, pn, pg = _port_loss_grads(arch)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    assert pn == rn == 2 * _seq(arch)
    _trees_close(pg, rg, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_loss_and_grads_match_reference_bf16(arch):
    rl, _, rg = _ref_loss_grads(arch, "bfloat16")
    pl, _, pg = _port_loss_grads(arch, "bfloat16")
    np.testing.assert_allclose(pl, rl, rtol=5e-2, atol=5e-2)
    _trees_close(pg, rg, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
def test_ssm_grads_finite_in_bf16(arch):
    """The SSD masks its decay exponents with −inf before exp; the
    backward pass must stay finite (no 0·inf)."""
    loss, _, grads = _port_loss_grads(arch, "bfloat16")
    assert np.isfinite(loss)
    for k, g in _flat(grads).items():
        assert torch.isfinite(g).all(), k


@pytest.mark.parametrize("kw", [{"remat": True}, {"q_chunk": 8},
                                {"loss_chunk": 8}],
                         ids=["remat", "q_chunk", "loss_chunk"])
def test_options_keep_the_loss_and_grads(kw):
    """remat, query-chunked attention and the chunked loss change how the
    loss is computed, not its value: equal to the port's plain loss
    (rounding apart), and to the reference's under the same option."""
    arch = "qwen3-1.7b"
    pl, pn, pg = _port_loss_grads(arch)
    ol, on, og = _port_loss_grads(arch, **kw)
    np.testing.assert_allclose(ol, pl, rtol=1e-6)
    assert on == pn
    _trees_close(og, pg, atol=1e-6, rtol=1e-5)
    rl, _, rg = _ref_loss_grads(arch, **kw)
    np.testing.assert_allclose(ol, rl, rtol=1e-5)
    _trees_close(og, rg, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-vl-72b"])
def test_masked_labels(arch):
    """Labels of −1 (the first 5 of each row) drop out of the loss and
    the count, as the reference's `take_along_axis` + mask make them."""
    rl, rn, rg = _ref_loss_grads(arch, masked=5)
    pl, pn, pg = _port_loss_grads(arch, masked=5)
    assert pn == rn == 2 * (_seq(arch) - 5)
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    _trees_close(pg, rg, atol=1e-5, rtol=1e-4)
    # and the masked positions carry no weight: any label there gives
    # the same loss
    _, pcfg = _cfgs(arch)
    params = lm_params_from_reference(_ref_tree(arch, 0))
    batch = _to_port(_train_batch(pcfg, 2, _seq(arch), masked=5),
                     torch.float32)
    other = dict(batch, labels=batch["labels"].clone())
    other["labels"][:, :5] = -7
    with torch.no_grad():
        a = T.loss_fn(pcfg)(params, batch)[0]
        b = T.loss_fn(pcfg)(params, other)[0]
    assert float(a) == float(b)


# ---------------------------------------------------------- input specs ---
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_input_specs_match_reference(arch):
    """Every arch and every shape cell (train, prefill, decode): the same
    keys, shapes and dtypes as the reference's ShapeDtypeStructs, on the
    meta device (no storage)."""
    for name, shape in configs.SHAPES.items():
        for batch in (None, 3):
            want = ref_configs.input_specs(ref_configs.get_config(arch),
                                           ref_configs.SHAPES[name],
                                           batch=batch)
            got = configs.input_specs(configs.get_config(arch), shape,
                                      batch=batch)
            assert got.keys() == want.keys(), (arch, name)
            for k in got:
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype).removeprefix("torch.") == \
                    str(want[k].dtype), (arch, name, k)
                assert got[k].device.type == "meta"
