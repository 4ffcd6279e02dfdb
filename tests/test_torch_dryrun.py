"""The port's dry-run (`repro_torch.launch.dryrun`) against the
reference's (`repro.launch.dryrun`, `repro.roofline.hlo_cost`):

 * `model_flops_estimate` and `flash_kernel_flops` equal the
   reference's for every arch × supported shape × single / multi (the
   reference's module sets XLA_FLAGS when imported, so it runs in a
   subprocess);
 * on one device, the matmul FLOPs `OpCost` records of the port's
   prefill and train step are within 1% of `HloCost(...).flops()` of
   the reference's compiled step, for five smoke configs (whisper's
   prefill less the reference's second projection of the encoder
   output to cross K/V, a designed difference, ROADMAP queue 3;
   minitron-4b, whose full config's heads the model axis does not
   divide);
 * on the production grid: `run_cell` at full size on `meta` writes the
   reference's JSON keys (less `raw_cost_*`) with collective bytes equal
   to the ring-factored `tp.moved` deltas; whisper-base's prefill runs
   under 'dp_replicated' with K4 on every head; `main` reports a cell
   that fails; the graph cell on the CPU counts its stripe as the
   reference's oracle does.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_grid
from repro_torch.parallel import tp

torch.set_num_threads(2)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_REF = r"""
import json, types
from repro.configs import ARCHS, SHAPES, get_config, supported_shapes
from repro.launch.dryrun import flash_kernel_flops, model_flops_estimate
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
out = {}
for a in ARCHS:
    for s in supported_shapes(a):
        cfg, sh = get_config(a), SHAPES[s]
        for m, shape in MESHES.items():
            out[f"{a}|{s}|{m}"] = [
                model_flops_estimate(cfg, sh),
                flash_kernel_flops(cfg, sh, types.SimpleNamespace(shape=shape))]
print(json.dumps(out))
"""


def test_model_and_flash_flops_equal_the_reference():
    pytest.importorskip("jax")
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    mine = {}
    for a in configs.ARCHS:
        for s in configs.supported_shapes(a):
            cfg, sh = configs.get_config(a), SHAPES[s]
            for m in ("single", "multi"):
                grid = make_production_grid(multi_pod=m == "multi")
                mine[f"{a}|{s}|{m}"] = [
                    dryrun.model_flops_estimate(cfg, sh),
                    dryrun.flash_kernel_flops(cfg, sh, grid)]
    assert mine == ref


# ------------------------------------------------ FLOPs on one device --
S, B = 64, 2


def _reference_flops(arch, kind):
    import jax

    from repro.configs import get_smoke_config, input_specs
    from repro.configs.base import ShapeConfig as RShape
    from repro.launch.mesh import make_host_mesh
    from repro.roofline.hlo_cost import HloCost
    from repro.serve.serve_step import make_prefill
    from repro.train.optimizer import AdamWConfig, init_opt_state
    from repro.train.train_step import (TrainOptions, abstract_params,
                                        make_train_step)

    cfg, mesh = get_smoke_config(arch), make_host_mesh()
    batch = input_specs(cfg, RShape("x", S, B, kind))
    p = abstract_params(cfg)
    if kind == "train":
        step = make_train_step(cfg, AdamWConfig(), mesh, TrainOptions(),
                               batch)[0]
        lowered = step.lower(p, jax.eval_shape(init_opt_state, p), batch)
    else:
        lowered = make_prefill(cfg, mesh, batch)[0].lower(p, batch)
    return HloCost(lowered.compile().as_text()).flops()


def _port_flops(arch, kind):
    from repro_torch.models import transformer as T
    from repro_torch.roofline.op_cost import OpCost
    from repro_torch.serve.serve_step import make_prefill
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import TrainOptions, make_train_step

    cfg = configs.get_smoke_config(arch)
    batch = configs.input_specs(cfg, ShapeConfig("x", S, B, kind))
    params = T.init(cfg, 0, "meta")
    with OpCost() as rec:
        if kind == "train":
            make_train_step(cfg, AdamWConfig(), TrainOptions(),
                            device="meta")(params, init_opt_state(params),
                                           batch)
        else:
            make_prefill(cfg, "meta")(params, batch)
    return rec.flops


def _designed(arch, kind) -> float:
    """FLOPs the reference's step does by design and the port's does
    not: whisper's prefill projects the encoder output to the cross K/V
    twice (in `_decdec_backbone` and again for the cache,
    `repro/models/transformer.py:441-445`); the port once."""
    if (arch, kind) != ("whisper-base", "prefill"):
        return 0.0
    c = configs.get_smoke_config(arch)
    return c.n_layers * 2 * (2.0 * B * S * c.d_model * c.n_kv_heads
                             * c.head_dim)


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "mamba2-370m", "whisper-base",
                                  "minitron-4b"])
def test_matmul_flops_match_the_reference_hlo(arch, kind):
    pytest.importorskip("jax")
    ref = _reference_flops(arch, kind) - _designed(arch, kind)
    assert _port_flops(arch, kind) == pytest.approx(ref, rel=0.01)


# ---------------------------------------------- the production grid --
REF_KEYS = {"arch", "shape", "mesh", "chips", "flops_per_device",
            "bytes_per_device", "coll_bytes_per_device", "coll_breakdown",
            "model_flops", "peak_memory_bytes", "compute_s", "memory_s",
            "collective_s", "bottleneck", "useful_flops_ratio",
            "step_time_s", "roofline_fraction", "compile_seconds",
            "memory_analysis"}
RING = {"all_reduce": ("all-reduce", 2), "all_max": ("all-reduce", 2),
        "all_gather": ("all-gather", 16), "gather_batch": ("all-gather", 16),
        "gather_data": ("all-gather", 16),
        "reduce_scatter": ("reduce-scatter", 1)}


@pytest.mark.parametrize("arch,shape,flash", [
    ("qwen3-1.7b", "decode_32k", 0),
    ("granite-moe-1b-a400m", "prefill_32k", 24),
])
def test_run_cell_on_the_production_grid(tmp_path, arch, shape, flash):
    before = dict(tp.moved)
    rec = dryrun.run_cell(arch, shape, "single", str(tmp_path))
    moved = {k: tp.moved[k] - before[k] for k in tp.KINDS}
    assert REF_KEYS <= set(rec) and not any(k.startswith("raw_cost")
                                            for k in rec)
    on_disk = json.loads(
        (tmp_path / f"{arch}__{shape}__single.json").read_text())
    assert on_disk == json.loads(json.dumps(rec))
    assert rec["chips"] == 256
    want = {}
    for kind, n in moved.items():
        if n:
            ref, factor = RING[kind]
            want[ref] = want.get(ref, 0) + n * factor
    assert want and rec["coll_breakdown"] == want
    assert rec["coll_bytes_per_device"] == sum(want.values())
    assert rec["kernel_calls"].get("flash", 0) == flash
    assert rec["flops_per_device"] > 0 and rec["peak_memory_bytes"] > 0
    if flash:
        cfg = configs.get_config(arch)
        grid = make_production_grid()
        k4 = dryrun.flash_kernel_flops(cfg, SHAPES[shape], grid)
        # K4's FLOP as its bound counts them (causal: S(S+1)/2 pairs)
        from repro_torch.roofline.kernels import k4_bound

        S_ = SHAPES[shape].seq_len
        per = k4_bound((2 * cfg.n_heads // 16, 2 * cfg.n_kv_heads // 16,
                        S_, S_, cfg.head_dim), True).ops
        assert per * flash == pytest.approx(k4, rel=1 / S_)


def test_a_cell_the_port_cannot_run_fails(tmp_path, monkeypatch):
    """whisper-base's 8 heads do not divide the model axis of 16 and its
    state fits: `pick_layout` gives 'dp_replicated', and its prefill
    runs on the production grid with K4 on every head, 18 calls (6
    causal, 12 bidirectional) whose FLOPs are `flash_kernel_flops`'
    "replicated over model" count.  `main` still reports a cell that
    fails (one made to fail here): "N cells failed", a non-zero exit
    and no file written."""
    from repro_torch.parallel.sharding import pick_layout
    from repro_torch.roofline.kernels import k4_bound

    cfg, shape = configs.get_config("whisper-base"), SHAPES["prefill_32k"]
    grid = make_production_grid()
    assert pick_layout(cfg, grid) == "dp_replicated"
    rec = dryrun.run_cell("whisper-base", "prefill_32k", "single",
                          str(tmp_path / "ok"))
    assert rec["kernel_calls"] == {"flash": 18}
    S_, rows = shape.seq_len, shape.global_batch // grid.data
    per = [k4_bound((rows * cfg.n_heads, rows * cfg.n_kv_heads, S_, S_,
                     cfg.head_dim), causal).ops for causal in (True, False)]
    assert 6 * per[0] + 12 * per[1] == pytest.approx(
        dryrun.flash_kernel_flops(cfg, shape, grid), rel=1 / S_)

    def broken(arch, *a, **kw):
        raise ValueError(f"{arch} made to fail")

    monkeypatch.setattr(dryrun, "lower_cell", broken)
    out = tmp_path / "fail"
    with pytest.raises(SystemExit, match="1 cells failed"):
        dryrun.main(["--arch", "whisper-base", "--shape", "prefill_32k",
                     "--out", str(out)])
    assert not out.exists() or not list(out.iterdir())


def test_graph_cell_counts_its_stripe(tmp_path):
    pytest.importorskip("jax")
    import dataclasses

    import numpy as np

    from repro.core.config_search import search_configuration
    from repro.core.oracle import count_with_plan
    from repro.core.pattern import house
    from repro.core.perf_model import GraphStats

    from repro_torch.graph.datasets import named_dataset
    from repro_torch.kernels import ops

    g = named_dataset("tiny-er")
    launches = dict(ops.launches)
    rec = dryrun.run_cell("graphpi", "count", "single", str(tmp_path),
                          device="cpu", graph=g)
    assert ops.launches == launches                 # CPU: nothing launched
    # the reference's plan, its root held to rank 0's stripe (v % 16 == 0)
    # through a label on the plan's first vertex
    stats = GraphStats(g.n, g.m, tri_cnt=max(g.m, 1))
    plan = search_configuration(house(), stats, use_iep=True).plan(house())
    stripe = dataclasses.replace(plan, vlabels=(1,) + (None,) * (plan.n - 1))
    want = count_with_plan(g.n, g.edge_array(), stripe,
                           labels=(np.arange(g.n) % 16 == 0).astype(int))
    assert rec["count"] == want // plan.iep_divisor > 0
    assert not rec["overflowed"] and rec["max_needed"] <= 1 << 15
    assert rec["kernel_calls"] and rec["kernel_compares"] > 0
    assert rec["coll_breakdown"] == {"all-reduce": 32.0}
    assert rec["bytes_per_device"] > 0 and rec["model_flops"] == 0.0
