"""Shared cases of the tests of attention kept whole on every model rank
(tests/test_torch_tp_replicated.py, tests/test_torch_tp_whole_heads.py):
one smoke config on one grid in float32, served and trained by spawned
gloo ranks, against the reference's sharded steps on the same mesh and
against the port's one device.

 * whisper-base (4 heads) at model 3 on W = 3: `pick_layout` gives
   'dp_replicated' (every leaf whole on every rank, the batch of 6
   split over the 3 ranks, 2 rows each);
 * minitron-4b (6 heads) at model 4 on W = 4, the layout forced to
   'tp2d' (`pick_layout` gives every smoke config 'dp_replicated',
   since each fits): wq / wk / wv / wo whole on every model rank, the
   MLP and the vocabulary split.

The test process writes the weights (the port's draw from seed 0, in
the reference's layout), B prompts and STEPS training batches of B × 16
(`write_inputs`); the reference's steps run in tests/ref_tp.py and
tests/ref_tp_train.py, started together under 4 forced host devices,
with the case's layout forced there too; the ranks (`rank_main`) serve
(prefill and GEN greedy decode steps), then take the first step's
gradient and STEPS AdamW steps.  Nothing here imports JAX.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch
import tp_cases as C
import tp_train_cases as TC

B, STEPS = 6, 2
# arch: (model axis = world, forced layout or None for pick_layout's)
CASES = {"whisper-base": (3, None), "minitron-4b": (4, "tp2d")}
LAYOUT = {"whisper-base": "dp_replicated", "minitron-4b": "tp2d"}


def write_inputs(out_dir, arch):
    from repro_torch.models import transformer as T

    cfg = C.cfg_of(arch)
    np.savez(f"{out_dir}/{arch}.weights.npz",
             **C.reference_tree(T.init(cfg, seed=0), cfg))
    np.savez(f"{out_dir}/{arch}.batch.npz", **C.prompts(cfg, B=B))
    np.savez(f"{out_dir}/{arch}.train.npz",
             **{f"{i}/{k}": v for i, b in enumerate(TC.batches(cfg, STEPS, B))
                for k, v in b.items()})


def start_reference(out_dir, arch):
    """The reference's serving and training steps of `arch` on its
    case's mesh, one process each, started together."""
    model, layout = CASES[arch]
    forced = [layout] if layout else []
    env = dict(os.environ, PYTHONPATH=os.path.join(C.ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    runs = [("ref_tp.py", [arch, B, C.S, C.GEN, [[1, model]], *forced]),
            ("ref_tp_train.py", [arch, [1, model], STEPS, TC.OPT, False,
                                 *forced])]
    procs = []
    for script, case in runs:
        path = os.path.join(out_dir, f"{script}.cases.json")
        with open(path, "w") as f:
            json.dump([case], f)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(C.HERE, script), path, out_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def finish_reference(procs):
    C.finish_reference(procs, timeout=TC.DEADLINE_S)


def load_train(out_dir, arch):
    """(whole port params, the STEPS torch batches) of `arch`."""
    raw = dict(np.load(f"{out_dir}/{arch}.train.npz"))
    return C.load_weights(out_dir, arch), [
        {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in raw.items()
         if k.split("/", 1)[0] == str(i)} for i in range(STEPS)]


def train(cfg, params, bs, grid=None, layout=None):
    """(first-step gradient, its global norm, the steps' losses and grad
    norms, the params and the AdamW state after them) of the port's
    step."""
    from repro_torch.parallel.sharding import in_order_of
    from repro_torch.train.optimizer import global_norm, init_opt_state

    step = TC.make_step(cfg, grid, layout)
    _, _, g = step.gradients(params, bs[0])
    gnorm = (global_norm(g) if grid is None else global_norm(
        g, pieces=in_order_of(g, step.pieces), grid=grid))
    state = init_opt_state(params)
    losses, norms = [], []
    for b in bs:
        params, state, met = step(params, state, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return g, float(gnorm), np.array(losses), np.array(norms), params, state


def one_device(out_dir, arch):
    """The port's one-device serving (and session, where the case takes
    `pick_layout`'s layout) and training of `arch`."""
    cfg = C.cfg_of(arch)
    with torch.inference_mode():
        served = C.serve(cfg, *C.load(out_dir, arch))
        session = (json.loads(json.dumps(C.session_run(arch, batch=B)))
                   if CASES[arch][1] is None else None)
    g, gnorm, losses, norms, params, _ = train(cfg,
                                               *load_train(out_dir, arch))
    return {"served": served, "session": session, "grads": g,
            "gnorm0": gnorm, "loss": losses, "grad_norm": norms,
            "params": params}


def ckpt_like(cfg):
    """The {"p", "o"} train state of `cfg` on `meta` (what a checkpoint
    restores into)."""
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import abstract_params

    like = abstract_params(cfg)
    return {"p": like, "o": init_opt_state(like)}


def same_leaves(a, b) -> bool:
    """Whether two trees hold equal leaves under equal paths."""
    from repro_torch.train.tree import flatten

    fa, fb = dict(flatten(a)), dict(flatten(b))
    return fa.keys() == fb.keys() and all(
        torch.equal(fa[k].cpu(), fb[k].cpu()) for k in fa)


def rank_main(rank, world, rdv, out_dir, arch):
    """A spawned rank of `arch`'s case: its shard served (and, where the
    case takes `pick_layout`'s layout, a session that evicts and admits
    a sequence; rank 0 writes <arch>.session.json), then trained;
    rank 0 writes <arch>.port.npz: the served outputs, the layout, how
    many leaves the rank's serving shard splits, the first-step
    gradient gathered whole ("g/...") and each rank's own blocks of it
    ("r<r>/..."), the global norm, the losses and grad norms, and the
    params after the steps ("p/...").  Asserts that every rank took the
    same tokens and reported the same metrics, that a one-device
    checkpoint of the initial state restores into the rank's pieces,
    and that the grid's checkpoint after the steps (written whole to
    <arch>.ckpt) restores into them again."""
    import torch.distributed as dist
    from torch_ranks import init_rank

    from repro_torch.convert import gather_params, shard_params
    from repro_torch.launch.mesh import gather, make_grid
    from repro_torch.parallel.sharding import leaves, pick_layout
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import state_pieces

    group, _ = init_rank(rank, world, rdv)
    model, layout = CASES[arch]
    grid = make_grid(model=model)
    cfg = C.cfg_of(arch)
    whole, batch = C.load(out_dir, arch)
    with torch.inference_mode():
        params = shard_params(whole, cfg, grid, layout=layout)
        split = sum(a.shape != b.shape for (_, a), (_, b) in
                    zip(leaves(params), leaves(whole)))
        out = C.serve(cfg, params, batch, grid, layout)
    toks = gather(group, out["tokens"].tolist())
    assert all(t == toks[0] for t in toks), toks
    if layout is None:
        # continuous batching with the rows split over every rank: the
        # admitted row's K/V written by the rank that holds slot 1
        with torch.inference_mode():
            run = C.session_run(arch, batch=B, group=group,
                                model_axis=model)
        assert all(r == run for r in gather(group, run)), run
        if rank == 0:
            with open(f"{out_dir}/{arch}.session.json", "w") as f:
                json.dump(run, f)
    whole, bs = load_train(out_dir, arch)
    params = shard_params(whole, cfg, grid, zero=True, layout=layout)
    pieces = state_pieces(cfg, grid, layout)
    one = f"{out_dir}/{arch}.ckpt-one"
    if rank == 0:
        ckpt.save(one, 0, {"p": whole, "o": init_opt_state(whole)})
    dist.barrier()
    tree, _ = ckpt.restore(one, ckpt_like(cfg), pieces=pieces, grid=grid)
    assert same_leaves(tree["p"], params)
    g, gnorm, losses, norms, params, state = train(cfg, params, bs, grid,
                                                   layout)
    seen = gather(group, (gnorm, losses.tolist(), norms.tolist()))
    assert all(s == seen[0] for s in seen), seen
    state_now = {"p": params, "o": state}
    ckpt.save(f"{out_dir}/{arch}.ckpt", STEPS, state_now, pieces=pieces,
              grid=grid)
    back, step = ckpt.restore(f"{out_dir}/{arch}.ckpt", ckpt_like(cfg),
                              pieces=pieces, grid=grid)
    assert step == STEPS and same_leaves(back, state_now)
    grads, got = gather(group, g), gather(group, params)
    if rank == 0:
        np.savez(
            f"{out_dir}/{arch}.port.npz", **out, split=split,
            layout=layout or pick_layout(cfg, grid), gnorm0=gnorm,
            loss=losses, grad_norm=norms,
            **TC.flat(gather_params(grads, cfg, grid, zero=True,
                                    layout=layout), "g"),
            **{k: v for r, gr in enumerate(grads)
               for k, v in TC.flat(gr, f"r{r}").items()},
            **TC.flat(gather_params(got, cfg, grid, zero=True,
                                    layout=layout), "p"))
    dist.destroy_process_group()


def port(out_dir, arch):
    return dict(np.load(f"{out_dir}/{arch}.port.npz"))


def check_served(out_dir, arch, want, against):
    """The ranks' served outputs against the reference's on the same
    mesh or the port's one device, within `tp_cases.TOL`, tokens
    equal."""
    got = port(out_dir, arch)
    other = (dict(np.load(f"{out_dir}/{arch}.1x{CASES[arch][0]}.npz"))
             if against == "reference" else want["served"])
    np.testing.assert_array_equal(got["tokens"], other["tokens"])
    for k in ("prefill", "decode"):
        np.testing.assert_allclose(got[k], other[k], atol=C.TOL, rtol=C.TOL,
                                   err_msg=f"{arch} {against} {k}")


def check_session(out_dir, arch, want):
    """The ranks' session (slot 1 evicted and a sequence admitted)
    against one device's: every slot's tokens equal."""
    with open(f"{out_dir}/{arch}.session.json") as f:
        got = json.load(f)
    assert got == want["session"]
    assert got["slot"] == 1 and len(got["slots"]["1"]) == 7


def check_grads(out_dir, arch, want):
    """The first-step gradient gathered whole, and its global norm,
    against one device's."""
    got = port(out_dir, arch)
    for k, b in TC.flat(want["grads"], "g").items():
        tol = TC.GRAD_TOL * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(got[k], b, atol=tol, rtol=0,
                                   err_msg=f"{arch} {k}")
    np.testing.assert_allclose(float(got["gnorm0"]), want["gnorm0"],
                               rtol=TC.NORM_RTOL)


def check_rank_blocks(out_dir, arch, want):
    """Each rank's own gradient of every leaf equals its `Piece` of the
    one-device gradient (not a multiple of it); returns the leaves each
    rank holds whole and those it holds a block of."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel.sharding import Grid, train_pieces
    from repro_torch.train.tree import flatten

    model, layout = CASES[arch]
    cfg = C.cfg_of(arch)
    got = port(out_dir, arch)
    like = T.init(cfg, device="meta")
    g1 = dict(flatten(want["grads"]))
    whole, split = set(), set()
    for r in range(model):
        grid = Grid(("data", "model"), (1, model), rank=r)
        pieces = dict(flatten(train_pieces(cfg, like, grid,
                                           layout or LAYOUT[arch])))
        for path, piece in pieces.items():
            b = piece.cut(g1[path], grid).numpy()
            tol = TC.GRAD_TOL * max(1.0, float(np.abs(b).max()))
            np.testing.assert_allclose(got[f"r{r}/{path}"], b, atol=tol,
                                       rtol=0, err_msg=f"{arch} rank {r} "
                                                       f"{path}")
            (whole if b.shape == g1[path].shape else split).add(path)
    return whole, split


def check_checkpoint(out_dir, arch):
    """The grid's checkpoint after the steps restores on one device into
    the params the ranks gathered whole."""
    from repro_torch.train import checkpoint as ckpt

    cfg = C.cfg_of(arch)
    got = port(out_dir, arch)
    tree, step = ckpt.restore(f"{out_dir}/{arch}.ckpt", ckpt_like(cfg))
    assert step == STEPS
    flat = TC.flat(tree["p"], "p")
    assert flat.keys() == {k for k in got if k.startswith("p/")}
    for k, a in flat.items():
        np.testing.assert_array_equal(a, got[k], err_msg=f"{arch} {k}")


def check_steps(out_dir, arch, want, against):
    """STEPS steps against the reference's sharded step on the same mesh
    or the port's one device: losses within `tp_train_cases.LOSS_TOL`,
    the params after them within its PARAM_TOL."""
    from repro_torch.convert import lm_params_from_reference

    got = port(out_dir, arch)
    if against == "reference":
        ref = dict(np.load(f"{out_dir}/{arch}.ref.1x{CASES[arch][0]}.npz"))
        loss = ref["loss"]
        params = lm_params_from_reference(
            C.nested({k[2:]: a for k, a in ref.items()
                      if k.startswith("p/")}))
    else:
        loss, params = want["loss"], want["params"]
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=TC.NORM_RTOL)
    np.testing.assert_allclose(got["loss"], loss, atol=TC.LOSS_TOL, rtol=0,
                               err_msg=f"{arch} {against} loss")
    for k, b in TC.flat(params, "p").items():
        np.testing.assert_allclose(got[k], b, atol=TC.PARAM_TOL, rtol=0,
                                   err_msg=f"{arch} {against} {k}")
