"""Port parity, the pieces of sharded training on the CPU: the
collectives autograd passes through, the vocabulary-parallel loss, the
ZeRO-3 layout, elastic checkpoints and `launch.train --model-axis`
under torchrun.

 * Collectives (spawned gloo ranks, W = 2 and W = 4): `copy_in`,
   `all_reduce` (backward as is, and summed), `all_gather` and
   `gather_data` give the forward and the input gradients of the same
   function on one process within 1e-6 · max(1, max |value|), and so
   does `_xent` with the output projection split by vocabulary.
 * Layout: `data_partition` follows `param_spec`'s DP entries,
   'dp_replicated' replicates, a piece is the intersection of its
   model part and its data block.
 * Checkpoints: one device's checkpoint restores into the pieces of a
   data 2 × model 2 grid (the counterpart of
   tests/test_checkpoint.py::test_elastic_resharding); a run saved at
   model 2 after 2 steps resumes on one device and at data 2 × model 2,
   its params after step 4 within 2e-5 of an uninterrupted one-device
   run; the reference's sharded train state (whisper-base at model 2,
   `tests/ref_tp_train.py`) restores into the port at W = 2.
 * Launcher: `torchrun --nproc-per-node 2 -m repro_torch.launch.train
   --model-axis 2` (bf16 smoke) prints the losses of `--model-axis 1`
   within 2e-3; SIGTERM to one of its ranks checkpoints every rank at
   the same step and the launch exits 0; a world of 3 at model 2 exits
   non-zero.
"""
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import tp_cases as TC
import tp_train_cases as C
from torch_ranks import init_rank, join_ranks, spawn_ranks, start_ranks

from repro_torch import configs
from repro_torch.parallel import sharding as SH
from repro_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

COLL_TOL = 1e-6
RESUME_TOL = 2e-5
RESUME_ARCHS = ["qwen3-1.7b", "mamba2-370m", "granite-moe-1b-a400m"]
LAUNCH_TOL = 2e-3
LAUNCH = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--batch",
          "4", "--seq", "16", "--log-every", "1"]
REF_CKPT = ("whisper-base", (1, 2))


# ---------------------------------------------------------- collectives ---
def _inputs(world, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(4, 6, generator=g, dtype=torch.float64),
            "w": torch.randn(world, 4, 6, generator=g, dtype=torch.float64),
            "c": torch.randn(4, 6 * world, generator=g, dtype=torch.float64)}


def _mine(fn, x):
    """(forward, gradient) of this rank's side: fn(x) -> (y, loss)."""
    x = x.clone().requires_grad_(True)
    y, loss = fn(x)
    return y.detach(), torch.autograd.grad(loss, x)[0]


def _one(fn, x, n, r):
    """(forward, gradient for rank r's input) of the same function on one
    process: fn(inputs) -> (y, loss), the n ranks' inputs as separate
    variables (n = 1: one input every rank shares)."""
    ts = [x.clone().requires_grad_(True) for _ in range(n)]
    y, loss = fn(ts)
    return y.detach(), torch.autograd.grad(loss, ts[r])[0]


def _cases(grid, world):
    """{name: (error of forward, error of the input gradient)} of each
    collective under `grid` against the same function on one process,
    each relative to max(1, max |value|) (float64 inputs; gloo carries
    them in fp32)."""
    from repro_torch.parallel import tp

    inp = _inputs(world)
    x, w, c = inp["x"], inp["w"], inp["c"]
    out = {}

    def err(got, want):
        return tuple(float((a - b).abs().max() / max(1.0, b.abs().max()))
                     for a, b in zip(got, want))

    def total(local):
        """A scalar loss summed over the model axis (every rank's)."""
        return tp.all_reduce(local.reshape(1))[0]

    if grid.model > 1:
        M, r = grid.model, grid.model_rank
        ws, cc, cg = w[:M], c[:, :6], c[:, :6 * M]
        # copy_in: x is every rank's; each rank's product reads it
        out["copy_in"] = err(
            _mine(lambda t: (t, total((tp.copy_in(t) * ws[r]).sum())), x),
            _one(lambda ts: (ts[0], sum((ts[0] * v).sum() for v in ws)),
                 x, 1, 0))
        # its slice form: every rank reads columns 2:4, the rest is r's
        out["copy_in_part"] = err(
            _mine(lambda t: (t, total(
                (tp.copy_in(t, (1, 2, 4)) * ws[r]).sum())), x),
            _one(lambda ts: (ts[0], (ts[0] * ws[r]).sum() + sum(
                (ts[0][:, 2:4] * v[:, 2:4]).sum()
                for q, v in enumerate(ws) if q != r)), x, 1, 0))
        # all_reduce, replicated readers (one loss, every rank's)
        out["all_reduce"] = err(
            _mine(lambda t: (lambda y: (y, (y * cc).sum()))(
                tp.all_reduce(t * ws[r])), x),
            _one(lambda ts: (lambda y: (y, (y * cc).sum()))(
                sum(t * v for t, v in zip(ts, ws))), x, M, r))
        # all_reduce, split readers: rank q's loss reads the sum with w_q
        out["all_reduce_summed"] = err(
            _mine(lambda t: (lambda y: (y, (y * ws[r]).sum()))(
                tp.all_reduce(t * ws[r], summed=True)), x),
            _one(lambda ts: (lambda y: (y, sum((y * v).sum() for v in ws)))(
                sum(t * v for t, v in zip(ts, ws))), x, M, r))
        # all_gather over the model axis, replicated readers
        out["all_gather"] = err(
            _mine(lambda t: (lambda y: (y, (y * cg).sum()))(
                tp.all_gather(t * ws[r], -1)), x),
            _one(lambda ts: (lambda y: (y, (y * cg).sum()))(
                torch.cat([t * v for t, v in zip(ts, ws)], -1)), x, M, r))
    if grid.data > 1:
        D, r = grid.data, grid.data_rank
        bs, cg = w[:D], c[:, :6 * D]
        # ZeRO-3's gather: every data rank reads the whole leaf with its
        # own rows (its loss weighs it by q + 1); the gradient comes back
        # summed over the ranks, each rank's block
        out["gather_data"] = err(
            _mine(lambda t: (lambda y: (y, (y * cg * (r + 1)).sum()))(
                tp.gather_data(t * bs[r], -1)), x),
            _one(lambda ts: (lambda y: (y, sum((y * cg * (q + 1)).sum()
                                               for q in range(D))))(
                torch.cat([t * v for t, v in zip(ts, bs)], -1)), x, D, r))
    return out


def _xent_case(grid):
    """The vocabulary-parallel `_xent` (tot, cnt, dx, dw of this rank's
    vocabulary block) against the whole one on one process."""
    from repro_torch.models import transformer as T
    from repro_torch.parallel import tp

    cfg = configs.get_smoke_config("qwen3-1.7b").scaled(dtype="float32")
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 8, cfg.d_model, generator=g)
    w = torch.randn(cfg.d_model, cfg.vocab, generator=g)
    labels = torch.randint(0, cfg.vocab, (2, 8), generator=g)
    labels[:, :2] = -1
    M, mr = grid.model, grid.model_rank
    Vl = cfg.vocab // M

    def run(xw, ww, ctx):
        xw = xw.clone().requires_grad_(True)
        ww = ww.clone().requires_grad_(True)
        with tp.using(ctx):
            tot, cnt = T._xent(cfg, {"lm_head": {"w": ww}}, xw, labels,
                               torch.float32, loss_chunk=4)
            loss = tot / cnt
            dx, dw = torch.autograd.grad(loss, (xw, ww))
        return loss.detach(), cnt, dx, dw

    got = run(x, w[:, mr * Vl:(mr + 1) * Vl], tp.Ctx(grid, cfg))
    want = run(x, w, None)
    return {"xent": (float((got[0] - want[0]).abs()),
                     max(float((got[2] - want[2]).abs().max()),
                         float((got[3] - want[3][:, mr * Vl:(mr + 1) * Vl])
                               .abs().max()),
                         float((got[1] - want[1]).abs())))}


def collectives_rank(rank, world, rdv, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import gather, make_grid
    from repro_torch.parallel import tp

    group, _ = init_rank(rank, world, rdv)
    found = {}
    for m in (world, 1):
        grid = make_grid(model=m)
        with tp.using(tp.Ctx(grid, None)):
            res = _cases(grid, world)
        if m > 1:
            res.update(_xent_case(grid))
        every = gather(group, res)
        for name in res:
            found[name] = [max(e[name][0] for e in every),
                           max(e[name][1] for e in every)]
    if rank == 0:
        with open(f"{out_dir}/collectives.{world}.json", "w") as f:
            json.dump(found, f)
    dist.destroy_process_group()


# ---------------------------------------------------------- checkpoints ---
def _state_pieces(cfg, grid):
    from repro_torch.train.train_step import state_pieces

    return state_pieces(cfg, grid)


def _run(cfg, grid, params, state, steps, start):
    from repro_torch.train.data import DataConfig, SyntheticLM

    step = C.make_step(cfg, grid)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=C.S,
                                  global_batch=C.B, seed=3), cfg)
    for s in range(start, start + steps):
        params, state, _ = step(params, state, {
            k: v.float() if v.is_floating_point() else v
            for k, v in data.batch(s).items()})
    return params, state


def _like(cfg):
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import abstract_params

    like = abstract_params(cfg)
    return {"p": like, "o": init_opt_state(like)}


def save_rank(rank, world, rdv, out_dir):
    """Model 2: each RESUME_ARCHS run 2 steps and saved, sharded."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_grid
    from repro_torch.train.train_step import init_train_state

    init_rank(rank, world, rdv)
    grid = make_grid(model=2)
    for arch in RESUME_ARCHS:
        cfg = C.cfg_of(arch)
        params, state = init_train_state(cfg, device="cpu", grid=grid)
        params, state = _run(cfg, grid, params, state, 2, 0)
        ckpt.save(f"{out_dir}/{arch}.resume", 2, {"p": params, "o": state},
                  pieces=_state_pieces(cfg, grid), grid=grid)
    dist.destroy_process_group()


def resume_rank(rank, world, rdv, out_dir):
    """Data 2 × model 2: one device's checkpoint restored into pieces,
    then each RESUME_ARCHS run resumed for steps 3 and 4 (rank 0 writes
    the params, gathered whole)."""
    import torch.distributed as dist

    from repro_torch.convert import gather_params
    from repro_torch.launch.mesh import gather, make_grid
    from repro_torch.parallel.sharding import leaves

    group, _ = init_rank(rank, world, rdv)
    grid = make_grid(model=2)
    # elastic restore of a whole (one-device) checkpoint into pieces
    cfg = C.cfg_of("granite-moe-1b-a400m")
    like = _like(cfg)
    pieces = _state_pieces(cfg, grid)
    got, step = ckpt.restore(f"{out_dir}/whole", like, pieces=pieces,
                             grid=grid)
    whole, _ = ckpt.restore(f"{out_dir}/whole", like)
    equal = [torch.equal(a, piece.cut(b, grid) if isinstance(
                 piece, SH.Piece) else b)
             for (_, a), (_, b), (_, piece) in zip(leaves(got), leaves(whole),
                                                   leaves(pieces))]
    split = sum(a.shape != b.shape for (_, a), (_, b) in
                zip(leaves(got["p"]), leaves(whole["p"])))
    every = gather(group, {"step": step, "equal": all(equal),
                           "leaves": len(equal), "split": split})
    if rank == 0:
        with open(f"{out_dir}/elastic.json", "w") as f:
            json.dump(every, f)
    # resume the model-2 runs here
    for arch in RESUME_ARCHS:
        cfg = C.cfg_of(arch)
        tree, step = ckpt.restore(f"{out_dir}/{arch}.resume", _like(cfg),
                                  pieces=_state_pieces(cfg, grid), grid=grid)
        assert step == 2
        params, _ = _run(cfg, grid, tree["p"], tree["o"], 2, 2)
        shards = gather(group, params)
        if rank == 0:
            np.savez(f"{out_dir}/{arch}.resumed.2x2.npz",
                     **C.flat(gather_params(shards, cfg, grid, zero=True),
                              "p"))
    dist.destroy_process_group()


def ref_restore_rank(rank, world, rdv, out_dir):
    """Model 2: the reference's sharded train state restored into pieces,
    gathered whole by rank 0."""
    import torch.distributed as dist

    from repro_torch.convert import gather_params
    from repro_torch.launch.mesh import gather, make_grid

    group, _ = init_rank(rank, world, rdv)
    grid = make_grid(model=2)
    arch, (data, model) = REF_CKPT
    cfg = C.cfg_of(arch)
    tree, step = ckpt.restore(f"{out_dir}/{arch}.ckpt.{data}x{model}",
                              _like(cfg), pieces=_state_pieces(cfg, grid),
                              grid=grid, cfg=cfg)
    p = gather(group, tree["p"])
    m = gather(group, tree["o"]["m"])
    if rank == 0:
        np.savez(f"{out_dir}/{arch}.restored.npz", step=int(tree["o"]["step"]),
                 ckpt_step=step,
                 **C.flat(gather_params(p, cfg, grid, zero=True), "p"),
                 **C.flat(gather_params(m, cfg, grid, zero=True), "m"))
    dist.destroy_process_group()


# ------------------------------------------------------------- launcher ---
def _torchrun(world, argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(TC.ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), "-m", "repro_torch.launch.train",
         *argv], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)


def _children(pid):
    """The processes `pid` started, from any of its threads."""
    out = []
    for task in os.listdir(f"/proc/{pid}/task"):
        with open(f"/proc/{pid}/task/{task}/children") as f:
            out += [int(p) for p in f.read().split()]
    return out


def _sigterm_run(ckpt_dir):
    """The 2-rank launch with SIGTERM sent to its rank-1 process once
    step 3 is logged; returns (exit code, output)."""
    proc = _torchrun(2, LAUNCH + ["--model-axis", "2", "--steps", "500",
                                  "--ckpt-dir", ckpt_dir,
                                  "--ckpt-every", "1000"])
    seen, deadline = [], time.monotonic() + 120
    try:
        for line in proc.stdout:
            seen.append(line)
            if line.startswith("step 3/"):
                workers = sorted(_children(proc.pid))
                os.kill(workers[-1], signal.SIGTERM)
                break
            assert time.monotonic() < deadline, "no step line in time"
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(10)
    return proc.returncode, "".join(seen) + out, err


def _losses(out):
    return [float(x) for x in re.findall(r"^step \d+/\d+ loss=([\d.]+)", out,
                                         re.M)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every spawned world and launch of this file, in three waves of
    at most eight processes (the suite's other workers share the
    host): the collectives' worlds beside the reference's run; the
    model-2 save, then its resumes; the launches."""
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import init_train_state
    from repro_torch.train.tree import tree_map

    d = str(tmp_path_factory.mktemp("tptrainckpt"))
    arch, mesh = REF_CKPT
    C.write_inputs(d, [arch])
    ref = C.start_reference(d, [[REF_CKPT]], save=[REF_CKPT])
    colls = [start_ranks(collectives_rank, w, d, d) for w in (2, 4)]
    # one device's checkpoint of a state 7 steps in, for the pieces
    cfg = C.cfg_of("granite-moe-1b-a400m")
    params, _ = init_train_state(cfg, device="cpu")
    state = init_opt_state(params)
    state["m"] = tree_map(lambda t: t * 0.5, params)
    state["v"] = tree_map(torch.square, params)
    state["step"].fill_(7)
    ckpt.save(f"{d}/whole", 7, {"p": params, "o": state})
    for h in colls:
        join_ranks(h)
    C.finish_reference(ref)
    spawn_ranks(save_rank, 2, d, d)
    resume = start_ranks(resume_rank, 4, d, d)
    ref_restore = start_ranks(ref_restore_rank, 2, d, d)
    want = {}
    for a in RESUME_ARCHS:
        cfg = C.cfg_of(a)
        tree, step = ckpt.restore(f"{d}/{a}.resume", _like(cfg))
        one, _ = _run(cfg, None, tree["p"], tree["o"], 2, 2)
        p0, s0 = init_train_state(cfg, device="cpu")
        straight, _ = _run(cfg, None, p0, s0, 4, 0)
        want[a] = (C.flat(one, "p"), C.flat(straight, "p"))
    join_ranks(resume)
    join_ranks(ref_restore)
    launches = {
        "model2": _torchrun(2, LAUNCH + ["--model-axis", "2", "--steps",
                                         "4"]),
        "world3": _torchrun(3, LAUNCH + ["--model-axis", "2", "--steps",
                                         "1"]),
    }
    sig = _sigterm_run(f"{d}/sigterm")
    one = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH,
         "--steps", "4"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(TC.ROOT, "src"),
                 OMP_NUM_THREADS="1"))
    runs = {"one": (one.returncode, one.stdout, one.stderr), "sigterm": sig}
    for name, proc in launches.items():
        out, err = proc.communicate(timeout=300)
        runs[name] = (proc.returncode, out, err)
    return d, want, runs


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["copy_in", "copy_in_part", "all_reduce",
                                  "all_reduce_summed", "all_gather",
                                  "gather_data", "xent"])
def test_collectives_pass_gradients_as_one_process(worlds, world, name):
    d, _, _ = worlds
    with open(f"{d}/collectives.{world}.json") as f:
        fwd, grad = json.load(f)[name]
    assert fwd <= COLL_TOL and grad <= COLL_TOL, (fwd, grad)


def test_one_device_checkpoint_restores_into_pieces(worlds):
    """The counterpart of test_checkpoint.py::test_elastic_resharding:
    every rank of the data 2 × model 2 world holds its piece of each
    leaf of one device's checkpoint, params and AdamW state."""
    d, _, _ = worlds
    with open(f"{d}/elastic.json") as f:
        every = json.load(f)
    assert len(every) == 4
    for r in every:
        assert r["step"] == 7 and r["equal"] and r["leaves"] > 0, r
        assert r["split"] > 0, r


@pytest.mark.parametrize("arch", RESUME_ARCHS)
@pytest.mark.parametrize("where", ["one-device", "data2-model2"])
def test_model2_checkpoint_resumes_elsewhere(worlds, arch, where):
    d, want, _ = worlds
    one, straight = want[arch]
    got = (one if where == "one-device" else
           dict(np.load(f"{d}/{arch}.resumed.2x2.npz")))
    for k, b in straight.items():
        np.testing.assert_allclose(got[k], b, atol=RESUME_TOL, rtol=0,
                                   err_msg=f"{arch} {where} {k}")


def test_reference_checkpoint_restores_at_model_2(worlds):
    d, _, _ = worlds
    from repro_torch.convert import lm_params_from_reference

    arch, (data, model) = REF_CKPT
    got = dict(np.load(f"{d}/{arch}.restored.npz"))
    assert int(got["ckpt_step"]) == int(got["step"]) == C.STEPS
    src = f"{d}/{arch}.ckpt.{data}x{model}/step_{C.STEPS}"
    with open(f"{src}/manifest.json") as f:
        man = json.load(f)
    leaves = {m["path"]: np.load(f"{src}/{m['file']}")
              for m in man["leaves"]}
    for prefix, key in (("p", "p"), ("o/m", "m")):
        tree = TC.nested({k[len(prefix) + 1:]: a for k, a in leaves.items()
                          if k.startswith(prefix + "/")})
        for k, b in C.flat(lm_params_from_reference(tree), key).items():
            np.testing.assert_array_equal(got[k], b, err_msg=k)


def test_checkpoint_maps_the_references_stacked_layers():
    cfg = configs.get_smoke_config("jamba-v0.1-52b")
    assert ckpt._reference_source("p/layers/9/ssm/in_proj/w", cfg) == (
        "p/blocks/l1/ssm/in_proj/w", 1)
    assert ckpt._reference_source("o/m/encoder/3/attn/wq/w", cfg) == (
        "o/m/encoder/attn/wq/w", 3)
    assert ckpt._reference_source("o/step", cfg) == ("o/step", None)


def test_launcher_model_axis_2_matches_model_axis_1(worlds):
    _, _, runs = worlds
    rc, out, err = runs["model2"]
    assert rc == 0, err[-3000:]
    rc1, out1, err1 = runs["one"]
    assert rc1 == 0, err1[-3000:]
    got, want = _losses(out), _losses(out1)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, atol=LAUNCH_TOL, rtol=0)
    ranks = re.findall(r"\[train\] rank (\d+): step=4 s/step=", out)
    assert ranks == ["0", "1"], out
    assert "[train] grid data=1 model=2 over 2 ranks" in out
    assert "still referenced" not in err, err[-2000:]


def test_sigterm_checkpoints_every_rank_at_one_step(worlds):
    d, _, runs = worlds
    rc, out, err = runs["sigterm"]
    assert rc == 0, (out + err)[-3000:]
    m = re.search(r"\[train\] preempted at step (\d+); checkpointed", out)
    assert m, out
    step = int(m.group(1))
    assert step >= 3 and ckpt.latest_step(f"{d}/sigterm") == step
    last = re.findall(r"\[train\] rank \d+: step=(\d+)", out)
    assert last == [str(step)] * 2, out


def test_world_model_axis_does_not_divide_exits_non_zero(worlds):
    _, _, runs = worlds
    rc, out, err = runs["world3"]
    assert rc != 0
    assert "does not divide" in err, err[-2000:]


# --------------------------------------------------------------- layout ---
@pytest.mark.parametrize("path,shape,want", [
    (("embed", "w"), (256, 64), (1, 2)),
    (("layers", "attn", "wq", "w"), (64, 64), (0, 2)),
    (("layers", "attn", "wo", "w"), (64, 64), (1, 2)),
    (("layers", "mlp", "gate"), (4, 64, 32), (1, 2)),
    (("layers", "mlp", "down"), (4, 32, 64), (2, 2)),
    (("layers", "mlp", "router", "w"), (64, 4), (0, 2)),
    (("layers", "ssm", "conv_w"), (4, 160), None),
    (("layers", "norm1", "scale"), (64,), None),
    (("layers", "attn", "wq", "w"), (63, 64), None),
])
def test_data_partition_follows_the_dp_entries(path, shape, want):
    g = SH.grid((2, 2), ("data", "model"))
    assert SH.data_partition(path, shape, g) == want
    assert SH.data_partition(path, shape, SH.grid((1, 2), ("data",
                                                           "model"))) is None


def test_dp_replicated_layout_replicates():
    """No config takes 'dp_replicated' at a model axis up to 8; a config
    whose heads the axis does not divide and whose state fits does."""
    cfg = configs.get_smoke_config("qwen3-1.7b")
    g = SH.grid((2, 3), ("data", "model"))
    assert SH.pick_layout(cfg, g) == "dp_replicated"
    assert SH.param_spec(("layers", "attn", "wq", "w"), (64, 64), g,
                         "dp_replicated") == ()
    assert SH.data_partition(("embed", "w"), (256, 64), g,
                             "dp_replicated") is None
    for arch in configs.ARCHS:
        for m in (1, 2, 4, 8):
            full = configs.get_config(arch)
            assert SH.pick_layout(full, SH.grid((1, m), ("data", "model"))
                                  ) == "tp2d", (arch, m)


def test_piece_is_model_part_then_data_block():
    cfg = configs.get_smoke_config("mamba2-370m")
    g = SH.grid((2, 2), ("data", "model"))
    shape = (cfg.d_model, 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads)
    whole = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape)
    for r in range(4):
        gr = SH.Grid(g.axis_names, g.sizes, rank=r)
        piece = SH.train_piece(("layers", "ssm", "in_proj", "w"), shape, cfg,
                               gr)
        dim, idx = piece.model
        want = whole.index_select(dim, idx(gr.model_rank)).chunk(2, 0)[
            gr.data_rank]
        assert torch.equal(piece.cut(whole, gr), want)
        assert np.array_equal(piece.cut(whole.numpy(), gr), want.numpy())
        d_l = cfg.d_inner // 2
        assert piece.shared == (1, 2 * d_l, 2 * d_l + 2 * cfg.ssm_state)
