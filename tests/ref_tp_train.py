"""The reference's sharded train step, for tests/test_torch_tp_train*.py.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
        PYTHONPATH=src python tests/ref_tp_train.py CASES.json OUT_DIR

Runs in a process of its own, because JAX fixes its device count at
start-up.  For each case [arch, [data, model], steps, opt, save(,
layout)] of CASES.json (`layout`, when given, replaces `pick_layout`'s
choice; the mesh over the first data·model of 4 host devices,
built as tests/ref_tp.py builds it: a default `Mesh`, whose axes are
auto) it loads the weights OUT_DIR/<arch>.weights.npz (the reference's
param layout as flat key paths) and the batches
OUT_DIR/<arch>.train.npz ("<step>/<name>" keys), places the params in
`param_shardings` and the AdamW state in `opt_state_shardings`, runs
`steps` steps of `repro.train.train_step.make_train_step` (remat on,
no query or loss chunking, the AdamWConfig fields `opt`) in float32,
and writes OUT_DIR/<arch>.ref.<data>x<model>.npz: each step's loss and
grad norm ("loss", "grad_norm") and the params after the last step
("p/<path>").  With `save`, it also writes the {"p", "o"} state with
`repro.train.checkpoint.save` under OUT_DIR/<arch>.ckpt.<data>x<model>.
"""
import json
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import configs  # noqa: E402
from repro.compat import set_mesh  # noqa: E402
from repro.train import checkpoint as ckpt  # noqa: E402
from repro.train import optimizer as O  # noqa: E402
from repro.train import train_step as TS  # noqa: E402
from ref_tp import unflatten  # noqa: E402


def flat(tree, prefix):
    paths, leaves, _ = ckpt._flatten(tree)
    return {f"{prefix}/{p}": np.asarray(v) for p, v in zip(paths, leaves)}


def run(cfg, params, batches, steps, opt, data, model, save_to=None):
    mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(data, model),
                ("data", "model"))
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in batches[0].items()}
    opts = TS.TrainOptions(remat=True, q_chunk=0, loss_chunk=0)
    out = {"loss": [], "grad_norm": []}
    with set_mesh(mesh):
        step, p_sh, o_sh, _ = TS.make_train_step(
            cfg, O.AdamWConfig(**opt), mesh, opts, shapes)
        params = jax.device_put(params, p_sh)
        state = jax.jit(O.init_opt_state, out_shardings=o_sh)(params)
        for b in batches[:steps]:
            params, state, m = step(params, state, b)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
        if save_to:
            ckpt.save(save_to, steps, {"p": params, "o": state})
    return {"loss": np.array(out["loss"]),
            "grad_norm": np.array(out["grad_norm"]), **flat(params, "p")}


def main(cases_path, out_dir):
    assert jax.device_count() == 4, jax.devices()
    pick = TS.pick_layout
    for arch, (data, model), steps, opt, save, *layout in json.load(
            open(cases_path)):
        TS.pick_layout = ((lambda cfg, mesh, _l=layout[0]: _l) if layout
                          else pick)
        cfg = configs.get_smoke_config(arch).scaled(dtype="float32")
        params = unflatten(dict(np.load(f"{out_dir}/{arch}.weights.npz")))
        raw = dict(np.load(f"{out_dir}/{arch}.train.npz"))
        batches = [{k.split("/", 1)[1]: jnp.asarray(v) for k, v in raw.items()
                    if k.split("/", 1)[0] == str(i)} for i in range(steps)]
        tag = f"{data}x{model}"
        save_to = f"{out_dir}/{arch}.ckpt.{tag}" if save else None
        np.savez(f"{out_dir}/{arch}.ref.{tag}.npz",
                 **run(cfg, params, batches, steps, opt, data, model,
                       save_to))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
