"""Shared cases of the port's sharded training tests
(tests/test_torch_tp_train*.py): the smoke configs of `tp_cases.ARCHS`
in float32, a global batch of 4 × 16 from the port's `SyntheticLM`
(seed 3), 3 steps of AdamW at lr 3e-4 with 5 warm-up steps.

The test process writes the weights (the port's draw from seed 0, in
the reference's layout) and the batches to a directory
(`write_inputs`); the reference's sharded train step runs in
`tests/ref_tp_train.py` under 4 forced host devices (one process per
group of cases, started together), the port's in spawned gloo ranks
(`rank_main`; the ranks import this module by name), and the port's
one-device gradients in the test process.  Nothing here imports JAX.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch
import tp_cases as C

ARCHS = C.ARCHS
B, S, STEPS = 4, 16, 3
OPT = dict(lr=3e-4, warmup_steps=5, total_steps=10)
GRAD_TOL = 1e-5           # times max(1, max |g|) of the leaf
NORM_RTOL = 1e-5
LOSS_TOL = 1e-5           # against the reference's sharded step
PARAM_TOL = 2e-5
# the families whose steps are held to the reference at every mesh; the
# others at data 2 x model 2 only (the reference's jamba is slow)
EVERY_MESH = ["qwen3-1.7b", "granite-34b", "granite-moe-1b-a400m",
              "mamba2-370m"]
cfg_of = C.cfg_of


def batches(cfg, steps=STEPS, b=B):
    """The port's SyntheticLM batches of b rows as numpy (float leaves in
    fp32)."""
    from repro_torch.train.data import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=b,
                                  seed=3), cfg)
    return [{k: (v.float() if v.is_floating_point() else v).numpy()
             for k, v in data.batch(i).items()} for i in range(steps)]


def write_inputs(out_dir, archs=ARCHS):
    from repro_torch.models import transformer as T

    for arch in archs:
        cfg = cfg_of(arch)
        np.savez(f"{out_dir}/{arch}.weights.npz",
                 **C.reference_tree(T.init(cfg, seed=0), cfg))
        np.savez(f"{out_dir}/{arch}.train.npz",
                 **{f"{i}/{k}": v for i, b in enumerate(batches(cfg))
                    for k, v in b.items()})


def load(out_dir, arch):
    """(whole port params, torch batches) of `arch`."""
    params = C.load_weights(out_dir, arch)
    raw = dict(np.load(f"{out_dir}/{arch}.train.npz"))
    out = []
    for i in range(STEPS):
        out.append({k.split("/", 1)[1]: torch.from_numpy(v)
                    for k, v in raw.items() if k.split("/", 1)[0] == str(i)})
    return params, out


def start_reference(out_dir, groups, save=()):
    """Start tests/ref_tp_train.py, one process per group of cases
    [(arch, (data, model))]; `save` names the cases that also write a
    checkpoint."""
    env = dict(os.environ, PYTHONPATH=os.path.join(C.ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = []
    for i, group in enumerate(groups):
        path = os.path.join(out_dir, f"train-cases-{i}.json")
        with open(path, "w") as f:
            json.dump([[a, list(m), STEPS, OPT, (a, tuple(m)) in save]
                       for a, m in group], f)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(C.HERE, "ref_tp_train.py"), path,
             out_dir], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


# seconds the reference's processes and the spawned ranks may take: the
# reference's jamba steps take ~30 s alone, longer beside other workers
DEADLINE_S = 600


def finish_reference(procs):
    C.finish_reference(procs, timeout=DEADLINE_S)


def make_step(cfg, grid=None, layout=None):
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    return TS.make_train_step(
        cfg, O.AdamWConfig(**OPT),
        TS.TrainOptions(remat=True, q_chunk=0, loss_chunk=0), device="cpu",
        grid=grid, layout=layout)


def one_device(out_dir, arch):
    """The port's first-step gradient and its global norm on one device."""
    from repro_torch.train.optimizer import global_norm

    params, bs = load(out_dir, arch)
    _, _, g = make_step(cfg_of(arch)).gradients(params, bs[0])
    return g, float(global_norm(g))


def flat(tree, prefix):
    from repro_torch.train.tree import flatten

    return {f"{prefix}/{p}": t.detach().numpy() for p, t in flatten(tree)}


def rank_main(rank, world, rdv, out_dir, plan):
    """A spawned rank: for each (model, archs) of `plan`, on the grid of
    that model-axis width, every arch's first-step gradient and global
    norm, then STEPS steps; rank 0 writes them, each gathered whole, with
    the losses, grad norms and the final params, to
    <arch>.port.<data>x<model>.npz, and how many leaves the rank holds a
    part of along the model and the data axis."""
    import torch.distributed as dist
    from torch_ranks import init_rank

    from repro_torch.convert import gather_params, shard_params
    from repro_torch.launch.mesh import gather, make_grid
    from repro_torch.parallel.sharding import in_order_of, leaves
    from repro_torch.train.optimizer import global_norm, init_opt_state

    group, _ = init_rank(rank, world, rdv)
    for m, archs in plan:
        grid = make_grid(model=m)
        for arch in archs:
            cfg = cfg_of(arch)
            whole, bs = load(out_dir, arch)
            step = make_step(cfg, grid)
            params = shard_params(whole, cfg, grid, zero=True)
            pieces = [p for _, p in leaves(step.pieces)]
            split = {"model": sum(p.model is not None for p in pieces),
                     "data": sum(p.data is not None for p in pieces)}
            _, _, g = step.gradients(params, bs[0])
            gnorm = float(global_norm(
                g, pieces=in_order_of(g, step.pieces), grid=grid))
            grads = gather(group, g)
            state = init_opt_state(params)
            losses, norms = [], []
            for b in bs:
                params, state, met = step(params, state, b)
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
            got = gather(group, params)
            if rank == 0:
                np.savez(
                    f"{out_dir}/{arch}.port.{grid.data}x{m}.npz",
                    gnorm0=gnorm, loss=np.array(losses),
                    grad_norm=np.array(norms), split_model=split["model"],
                    split_data=split["data"],
                    **flat(gather_params(grads, cfg, grid, zero=True), "g"),
                    **flat(gather_params(got, cfg, grid, zero=True), "p"))
    dist.destroy_process_group()


def check_grads(out_dir, arch, mesh, want):
    """The first-step gradient gathered whole against one device's
    `want` = (grads, global norm); some leaf is split over the model
    axis and, at data 2, over the data axis."""
    data, model = mesh
    got = dict(np.load(f"{out_dir}/{arch}.port.{data}x{model}.npz"))
    g1, n1 = want
    for k, b in flat(g1, "g").items():
        tol = GRAD_TOL * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(got[k], b, atol=tol, rtol=0,
                                   err_msg=f"{arch} {mesh} {k}")
    np.testing.assert_allclose(float(got["gnorm0"]), n1, rtol=NORM_RTOL)
    assert got["split_model"] > 0
    assert got["split_data"] > 0 or data == 1


def check_steps(out_dir, arch, mesh):
    """STEPS steps against the reference's sharded step on the same
    mesh: losses within LOSS_TOL, the params after them within
    PARAM_TOL."""
    from repro_torch.convert import lm_params_from_reference

    data, model = mesh
    tag = f"{data}x{model}"
    got = dict(np.load(f"{out_dir}/{arch}.port.{tag}.npz"))
    ref = dict(np.load(f"{out_dir}/{arch}.ref.{tag}.npz"))
    np.testing.assert_allclose(got["loss"], ref["loss"], atol=LOSS_TOL,
                               rtol=0, err_msg=f"{arch} {mesh} loss")
    tree = C.nested({k[2:]: a for k, a in ref.items() if k.startswith("p/")})
    for k, b in flat(lm_params_from_reference(tree), "p").items():
        np.testing.assert_allclose(got[k], b, atol=PARAM_TOL, rtol=0,
                                   err_msg=f"{arch} {mesh} {k}")
