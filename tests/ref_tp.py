"""The reference's sharded serving steps, for tests/test_torch_tp_serving*.py.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
        PYTHONPATH=src python tests/ref_tp.py CASES.json OUT_DIR

Runs in a process of its own, because JAX fixes its device count at
start-up.  For each case [arch, B, S, gen, meshes(, layout)] of
CASES.json (a mesh is [data, model] over the first data·model of 4
host devices; `layout`, when given, replaces `pick_layout`'s choice) it
loads the weights OUT_DIR/<arch>.weights.npz (the reference's param
layout as flat key paths, written by the test) and the prompts
OUT_DIR/<arch>.batch.npz, runs `repro.serve.serve_step.make_prefill`
and `gen` greedy steps of `make_decode` in float32 under the mesh, and
writes OUT_DIR/<arch>.<data>x<model>.npz: the prefill logits, each
decode step's logits and the greedy tokens.
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
from repro.models import transformer as T  # noqa: E402
from repro.serve import serve_step  # noqa: E402
from repro.serve.serve_step import make_decode, make_prefill  # noqa: E402
from repro.serve.session import seed_cache  # noqa: E402


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, a in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(a)
    return tree


def run(cfg, params, batch, B, S, gen, data, model):
    mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(data, model),
                ("data", "model"))
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in batch.items()}
    with set_mesh(mesh):
        prefill, _, _ = make_prefill(cfg, mesh, shapes, q_chunk=0)
        logits, pc = prefill(params, batch)
        decode, _, c_sh, _ = make_decode(cfg, mesh, batch=B, max_seq=S + gen,
                                         cache_dtype=jnp.float32)
        cache = jax.jit(lambda: T.init_cache(cfg, B, S + gen, jnp.float32),
                        out_shardings=c_sh)()
        # seeded on one device (an eager scatter into a cache split along
        # the sequence fails in this JAX), then put in the decode step's
        # shardings
        def host(tree):
            return jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), tree)

        cache = jax.device_put(seed_cache(host(cache), host(pc), S), c_sh)
        # tokens go in as host arrays: the step's jit places them
        tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
        out = {"prefill": np.asarray(logits), "tokens": [tok], "decode": []}
        for i in range(gen):
            lg, cache = decode(params, tok, cache, S + i)
            out["decode"].append(np.asarray(lg))
            tok = np.argmax(out["decode"][-1], -1).astype(np.int32)[:, None]
            out["tokens"].append(tok)
    return {"prefill": out["prefill"], "decode": np.stack(out["decode"]),
            "tokens": np.concatenate(out["tokens"], axis=1)}


def main(cases_path, out_dir):
    assert jax.device_count() == 4, jax.devices()
    pick = serve_step.pick_layout
    for arch, B, S, gen, meshes, *layout in json.load(open(cases_path)):
        serve_step.pick_layout = (
            (lambda cfg, mesh, _l=layout[0]: _l) if layout else pick)
        cfg = configs.get_smoke_config(arch).scaled(dtype="float32")
        params = unflatten(dict(np.load(f"{out_dir}/{arch}.weights.npz")))
        batch = {k: jnp.asarray(v) for k, v in
                 np.load(f"{out_dir}/{arch}.batch.npz").items()}
        for data, model in meshes:
            np.savez(f"{out_dir}/{arch}.{data}x{model}.npz",
                     **run(cfg, params, batch, B, S, gen, data, model))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
