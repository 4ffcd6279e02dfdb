"""Shared cases of the port's tensor-parallel serving tests
(tests/test_torch_tp_serving*.py): one smoke config of every LM
family (and granite-34b, whose one KV head puts the decode cache's
sequence over the model axis), in float32, batch 2, a 16-token prompt
and 4 greedy decode steps.

The test process draws the weights (`write_inputs`: the port's
`transformer.init` from seed 0, stacked into the reference's layout)
and writes them with the prompts to a directory; the reference's
sharded steps run in `tests/ref_tp.py` under 4 forced host devices
(one process per mesh, started together), the port's in spawned gloo
ranks (`rank_main`; the ranks import this module by name), and the
port's one-device steps in the test process.  Nothing here imports
JAX.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

ARCHS = ["qwen3-1.7b", "granite-34b", "granite-moe-1b-a400m", "mamba2-370m",
         "jamba-v0.1-52b", "whisper-base", "qwen2-vl-72b"]
B, S, GEN = 2, 16, 4
TOL = 1e-4
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def cfg_of(arch):
    from repro_torch import configs

    return configs.get_smoke_config(arch).scaled(dtype="float32")


def prompts(cfg, seed=1, B=B):
    """numpy prompts of B rows for `cfg`'s family (the reference's
    input spec)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(
                    np.float32),
                "positions3": np.broadcast_to(
                    np.arange(S, dtype=np.int32), (B, 3, S)).copy()}
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    return batch


def reference_tree(tree, cfg) -> dict:
    """The port's param tree in the reference's layout, flat: numpy
    leaves under "a/b/c" key paths, the layers stacked for its scan
    (block b, position j of `blocks/l<j>` is layer b·block_len + j; the
    inverse of `convert.lm_params_from_reference`)."""
    from repro_torch.models.transformer import _block_len
    from repro_torch.parallel.sharding import leaves

    def flat(node, prefix):
        return {"/".join((prefix,) + p): t.numpy()
                for p, t in leaves(node)}

    def stacked(parts, prefix):
        cols = [flat(p, prefix) for p in parts]
        return {k: np.stack([c[k] for c in cols]) for k in cols[0]}

    blk = _block_len(cfg)
    out = {}
    for k, v in tree.items():
        if k == "layers":
            for j in range(blk):
                out.update(stacked(v[j::blk], f"blocks/l{j}"))
        elif k in ("encoder", "cross"):
            out.update(stacked(v, k))
        else:
            out.update(flat(v, k))
    return out


def write_inputs(out_dir, archs=ARCHS):
    """Weights (the port's draw from seed 0) and prompts, per arch."""
    from repro_torch.models import transformer as T

    for arch in archs:
        cfg = cfg_of(arch)
        np.savez(f"{out_dir}/{arch}.weights.npz",
                 **reference_tree(T.init(cfg, seed=0), cfg))
        np.savez(f"{out_dir}/{arch}.batch.npz", **prompts(cfg))


def start_reference(out_dir, meshes, archs=ARCHS):
    """Start tests/ref_tp.py, one process per mesh ([data, model])."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = []
    for data, model in meshes:
        cases = os.path.join(out_dir, f"cases-{data}x{model}.json")
        with open(cases, "w") as f:
            json.dump([[a, B, S, GEN, [[data, model]]] for a in archs], f)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "ref_tp.py"), cases,
             out_dir], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def finish_reference(procs, timeout=240):
    for proc in procs:
        out, _ = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, out[-4000:]


def nested(flat: dict) -> dict:
    """A nested dict from flat "a/b/c" key paths."""
    tree: dict = {}
    for key, a in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    return tree


def load_weights(out_dir, arch):
    """The port params of `arch` from `write_inputs`' weights file."""
    from repro_torch.convert import lm_params_from_reference

    return lm_params_from_reference(
        nested(dict(np.load(f"{out_dir}/{arch}.weights.npz"))))


def load(out_dir, arch):
    """(port params, torch batch) of `arch` from `write_inputs`' files."""
    batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
             else torch.from_numpy(v)
             for k, v in np.load(f"{out_dir}/{arch}.batch.npz").items()}
    return load_weights(out_dir, arch), batch


def serve(cfg, params, batch, grid=None, layout=None):
    """The port's prefill and GEN greedy decode steps (float32 cache)
    on the CPU, under `grid` (and `layout`, default `pick_layout`'s) or
    on one device: {"prefill", "decode", "tokens"} as numpy."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import kv_layout, pick_layout
    from repro_torch.serve.serve_step import make_decode, make_prefill
    from repro_torch.serve.session import seed_cache

    B = next(iter(batch.values())).shape[0]
    prefill = make_prefill(cfg, "cpu", q_chunk=0, grid=grid, layout=layout)
    logits, pc = prefill(params, batch)
    cache = T.init_cache(cfg, B, S + GEN, dtype=torch.float32, grid=grid,
                         layout=layout)
    off = 0
    if grid is not None and kv_layout(
            cfg, B, S + GEN, grid,
            layout or pick_layout(cfg, grid)) == "seq":
        off = grid.model_rank * ((S + GEN) // grid.model)
    seed_cache(cache, pc, S, off)
    decode = make_decode(cfg, "cpu", grid=grid, batch=B, max_seq=S + GEN,
                         layout=layout)
    tok = logits.argmax(-1)[:, None]
    out = {"prefill": logits.numpy(), "tokens": [tok.numpy()], "decode": []}
    for i in range(GEN):
        lg, cache = decode(params, tok, cache, S + i)
        out["decode"].append(lg.numpy())
        tok = lg.argmax(-1)[:, None]
        out["tokens"].append(tok.numpy())
    return {"prefill": out["prefill"], "decode": np.stack(out["decode"]),
            "tokens": np.concatenate(out["tokens"], axis=1)}


SESSION_ARCHS = ["granite-moe-1b-a400m", "jamba-v0.1-52b"]


def session_run(arch, batch=4, **kw):
    """An `LMSession` of `arch`'s smoke config in float32 (`batch` rows,
    a 16-token prompt, 6 tokens): 2 decode steps, slot 1 evicted and a
    new sequence admitted in its place, then decoding to the end.
    Returns every slot's tokens and the evicted row's."""
    from repro_torch import configs
    from repro_torch.serve.session import LMSession

    smoke = configs.get_smoke_config
    configs.get_smoke_config = lambda a: smoke(a).scaled(dtype="float32")
    try:
        s = LMSession(arch, smoke=True, batch=batch, prompt_len=S, gen=6,
                      device="cpu", **kw)
    finally:
        configs.get_smoke_config = smoke
    s.start()
    s.decode_steps(2)
    evicted = s.evict(1).tolist()
    slot = s.admit()
    while s.remaining:
        s.decode_steps(2)
    return {"slot": slot, "evicted": evicted,
            "slots": {b: list(map(int, t))
                      for b, t in sorted(s._slot_tokens.items())}}


def rank_main(rank, world, rdv, out_dir, models, archs=ARCHS):
    """A spawned rank: for each model-axis width in `models`, every
    arch's shard, its served logits and tokens (rank 0 writes them to
    <arch>.port.<data>x<model>.npz).  Asserts that some leaf is split
    and that every rank took the same tokens."""
    import torch.distributed as dist
    from torch_ranks import init_rank

    from repro_torch.convert import shard_params
    from repro_torch.launch.mesh import gather, make_grid
    from repro_torch.parallel.sharding import leaves

    group, _ = init_rank(rank, world, rdv)
    with torch.inference_mode():
        for m in models:
            grid = make_grid(model=m)
            for arch in archs:
                cfg = cfg_of(arch)
                whole, batch = load(out_dir, arch)
                params = shard_params(whole, cfg, grid)
                split = sum(a.shape != b.shape for (_, a), (_, b) in
                            zip(leaves(params), leaves(whole)))
                assert split > 0, (arch, m)
                out = serve(cfg, params, batch, grid)
                toks = gather(group, out["tokens"].tolist())
                assert all(t == toks[0] for t in toks), (arch, m, toks)
                if rank == 0:
                    np.savez(f"{out_dir}/{arch}.port.{grid.data}x{m}.npz",
                             split=split, **out)
        if world == 4:
            # continuous batching with the batch split over the data axis
            runs = {a: session_run(a, group=group, model_axis=2)
                    for a in SESSION_ARCHS}
            assert all(r == runs for r in gather(group, runs)), runs
            if rank == 0:
                with open(f"{out_dir}/sessions.json", "w") as f:
                    json.dump(runs, f)
    dist.destroy_process_group()


def check(out_dir, arch, mesh, want):
    """The port's sharded run on `mesh` against the reference's on the
    same mesh and against the port's one-device run `want`."""
    data, model = mesh
    got = dict(np.load(f"{out_dir}/{arch}.port.{data}x{model}.npz"))
    ref = dict(np.load(f"{out_dir}/{arch}.{data}x{model}.npz"))
    for other in (ref, want):
        np.testing.assert_array_equal(got["tokens"], other["tokens"])
        for k in ("prefill", "decode"):
            np.testing.assert_allclose(got[k], other[k], atol=TOL, rtol=TOL,
                                       err_msg=f"{arch} {mesh} {k}")
    assert got["split"] > 0
