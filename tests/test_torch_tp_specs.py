"""Port parity of the sharding rules: `repro_torch.parallel.sharding`
against `repro.parallel.sharding`, field-equal, for every config of
`ARCHS` on grids (1, 1), (1, 2), (2, 2), (1, 4), (16, 16) and (2, 16,
16): `pick_layout`, `param_spec` of every leaf, `batch_specs`,
`choose_kv_spec` and `cache_shardings`.  Then the runtime partition:
`convert.shard_params` / `gather_params` and each rank's share.

The reference's functions read only a mesh's `shape` and `axis_names`,
so a stand-in mesh is enough for every grid, the production ones
included; the two that wrap their specs in `NamedSharding` get a
stand-in for it that returns the spec.  The reference's trees are
`jax.eval_shape`'s (no weights drawn), the port's are on the `meta`
device.  A port leaf is compared with the reference's stacked leaf
without its stack entries.
"""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import transformer as RT
from repro.parallel import sharding as RS

from repro_torch import configs
from repro_torch.convert import gather_params, shard_params
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as S

GRIDS = [((1, 1), ("data", "model")), ((1, 2), ("data", "model")),
         ((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
         ((16, 16), ("data", "model")),
         ((2, 16, 16), ("pod", "data", "model"))]
GRID_IDS = ["x".join(map(str, g[0])) for g in GRIDS]


def _mesh(shape, names):
    return SimpleNamespace(axis_names=tuple(names),
                           shape=dict(zip(names, shape)))


@pytest.fixture(autouse=True)
def _spec_sharding(monkeypatch):
    monkeypatch.setattr(RS, "NamedSharding", lambda mesh, spec: tuple(spec))


def _names(kp):
    return tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in kp)


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch, smoke):
    cfg = (ref_configs.get_smoke_config(arch) if smoke
           else ref_configs.get_config(arch))
    tree = jax.eval_shape(lambda: RT.init(cfg, jax.random.PRNGKey(0)))
    return cfg, tree


def _ref_path(cfg, path, layer):
    """The reference's key path for the port's leaf `path` of layer
    `layer` (None outside the per-layer lists), and its stack depth."""
    if path[0] == "layers":
        return ("blocks", f"l{layer % RT._block_len(cfg)}") + path[1:], 1
    return path, int(path[0] in ("encoder", "cross"))


def _port_leaves(tree):
    """(path, layer index or None, leaf) of the port's param tree."""
    for k, v in tree.items():
        if isinstance(v, list):
            for i, lp in enumerate(v):
                for p, leaf in S.leaves(lp, (k,)):
                    yield p, i, leaf
        else:
            for p, leaf in S.leaves(v, (k,)):
                yield p, None, leaf


@pytest.mark.parametrize("arch", configs.ARCHS)
@pytest.mark.parametrize("shape,names", GRIDS, ids=GRID_IDS)
def test_param_specs_match_reference(arch, shape, names):
    for smoke in (True, False):
        rcfg, rtree = _ref_shapes(arch, smoke)
        pcfg = (configs.get_smoke_config(arch) if smoke
                else configs.get_config(arch))
        ref_mesh, grid = _mesh(shape, names), S.grid(shape, names)
        layout = S.pick_layout(pcfg, grid)
        assert layout == RS.pick_layout(rcfg, ref_mesh)
        ref_leaves = {_names(kp): v for kp, v in
                      jax.tree_util.tree_flatten_with_path(rtree)[0]}
        ptree = T.init(pcfg, device="meta")
        seen = set()
        for path, layer, leaf in _port_leaves(ptree):
            rpath, stack = _ref_path(rcfg, path, layer)
            rleaf = ref_leaves[rpath]
            seen.add(rpath)
            assert tuple(leaf.shape) == tuple(rleaf.shape[stack:]), path
            spec = S.param_spec(path, tuple(leaf.shape), grid, layout)
            want = tuple(RS.param_spec(rpath, rleaf.shape, ref_mesh, layout))
            assert spec == want[stack:] or spec == want == (), (
                arch, smoke, path, spec, want)
        assert seen == set(ref_leaves)
        # param_shardings: the tree of the same specs
        tree_specs = S.param_shardings(ptree, grid, layout)
        for (path, spec), (_, _, leaf) in zip(
                S.leaves(tree_specs), _port_leaves(ptree)):
            assert spec == S.param_spec(path, tuple(leaf.shape), grid, layout)


@pytest.mark.parametrize("arch", configs.ARCHS)
@pytest.mark.parametrize("shape,names", GRIDS, ids=GRID_IDS)
def test_batch_kv_cache_specs_match_reference(arch, shape, names):
    rcfg = ref_configs.get_smoke_config(arch)
    pcfg = configs.get_smoke_config(arch)
    ref_mesh, grid = _mesh(shape, names), S.grid(shape, names)
    for B, seq in ((1, 24), (2, 24), (4, 32), (32, 64), (6, 30)):
        bshape = {"tokens": jax.ShapeDtypeStruct((B, seq), np.int32),
                  "embeds": jax.ShapeDtypeStruct((B, seq, 8), np.float32)}
        for layout in ("tp2d", "dp_replicated"):
            want = RS.batch_specs(bshape, ref_mesh, layout)
            got = S.batch_specs(
                {k: torch.empty(v.shape, device="meta")
                 for k, v in bshape.items()}, grid, layout)
            assert got == want, (B, layout, got, want)
        assert S.choose_kv_spec(pcfg, B, seq, grid) == tuple(
            RS.choose_kv_spec(rcfg, B, seq, ref_mesh))
        rcache = jax.eval_shape(lambda: RT.init_cache(rcfg, B, seq))
        want = RS.cache_shardings(rcfg, rcache, B, seq, ref_mesh)
        pcache = T.init_cache(pcfg, B, seq, device="meta")
        got = S.cache_shardings(pcfg, pcache, B, seq, grid)
        blk = RT._block_len(rcfg)
        for i, lc in enumerate(got["layers"]):
            for k, spec in lc.items():
                assert spec == want["blocks"][f"l{i % blk}"][k][1:], (i, k)
        if "cross_kv" in got:
            for lc in got["cross_kv"]:
                assert lc["k"] == lc["v"] == want["cross_kv"][2:]


def test_opt_state_shardings_mirror_params():
    grid = S.grid((2, 2), ("data", "model"))
    cfg = configs.get_smoke_config("qwen3-1.7b")
    p = S.param_shardings(T.init(cfg, device="meta"), grid)
    assert S.opt_state_shardings(None, p, grid) == {"m": p, "v": p,
                                                    "step": ()}


# ------------------------------------------------------ runtime partition
SHARD_ARCHS = ["qwen3-1.7b", "granite-34b", "granite-moe-1b-a400m",
               "mamba2-370m", "jamba-v0.1-52b", "whisper-base",
               "qwen2-vl-72b"]


@pytest.mark.parametrize("arch", SHARD_ARCHS)
@pytest.mark.parametrize("model", [2, 4])
def test_shard_then_gather_is_the_whole_tree(arch, model):
    cfg = configs.get_smoke_config(arch)
    tree = T.init(cfg, seed=3)
    grid = S.grid((1, model), ("data", "model"))
    shards = [shard_params(tree, cfg, grid, model_rank=r)
              for r in range(model)]
    whole = gather_params(shards, cfg, grid)
    split = 0
    for (path, a), (_, b), (_, s) in zip(S.leaves(whole), S.leaves(tree),
                                         S.leaves(shards[-1])):
        assert torch.equal(a, b), path
        split += s.shape != b.shape
    assert split > 0


def test_mamba_split_follows_heads():
    cfg = configs.get_smoke_config("mamba2-370m")
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    grid = S.grid((1, 2), ("data", "model"))
    p = T.init(cfg, seed=0)["layers"][0]["ssm"]
    part = shard_params({"layers": [{"ssm": p}]}, cfg, grid,
                        model_rank=1)["layers"][0]["ssm"]
    w = p["in_proj"]["w"]
    want = torch.cat([w[:, di // 2:di], w[:, di + di // 2:2 * di],
                      w[:, 2 * di:2 * di + 2 * ds],
                      w[:, 2 * di + 2 * ds + nh // 2:]], dim=1)
    assert torch.equal(part["in_proj"]["w"], want)
    assert part["A_log"].shape == (nh // 2,)
    assert part["conv_w"].shape == (cfg.conv_width, di // 2 + 2 * ds)


def test_kv_weights_stay_whole_where_heads_do_not_divide():
    cfg = configs.get_smoke_config("granite-34b")        # 8 heads over 1
    grid = S.grid((1, 2), ("data", "model"))
    tree = T.init(cfg, seed=0)
    part = shard_params(tree, cfg, grid, model_rank=0)
    a, whole = part["layers"][0]["attn"], tree["layers"][0]["attn"]
    assert torch.equal(a["wk"]["w"], whole["wk"]["w"])
    assert a["wq"]["w"].shape[1] == whole["wq"]["w"].shape[1] // 2
    assert S.kv_layout(cfg, 4, 32, grid) == "seq"
    assert S.kv_layout(cfg, 4, 31, grid) == "whole"
    assert S.kv_layout(configs.get_smoke_config("qwen3-1.7b"), 4, 32,
                       grid) == "heads"


def test_heads_that_do_not_divide_raise():
    """Heads that do not divide the model axis no longer raise: under
    'tp2d' (forced: the smoke config fits, so `pick_layout` gives
    'dp_replicated') each of the 4 model ranks holds minitron's wq /
    wk / wv / wo whole and its quarter of the MLP and the vocabulary;
    under 'dp_replicated' every leaf whole."""
    cfg = configs.get_smoke_config("minitron-4b")         # 6 heads
    grid = S.grid((1, 4), ("data", "model"))
    assert S.heads_whole(cfg, grid) and S.pick_layout(cfg, grid) == (
        "dp_replicated")
    tree = T.init(cfg, seed=0)
    for r in range(4):
        part = shard_params(tree, cfg, grid, model_rank=r, layout="tp2d")
        for i, lp in enumerate(part["layers"]):
            whole = tree["layers"][i]
            for w in ("wq", "wk", "wv", "wo"):
                assert torch.equal(lp["attn"][w]["w"], whole["attn"][w]["w"])
            for w, dim in (("gate", 1), ("up", 1), ("down", 0)):
                assert torch.equal(lp["mlp"][w]["w"], whole["mlp"][w][
                    "w"].chunk(4, dim)[r])
        assert torch.equal(part["embed"]["w"],
                           tree["embed"]["w"].chunk(4, 0)[r])
        replicated = shard_params(tree, cfg, grid, model_rank=r)
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(S.leaves(replicated), S.leaves(tree)))
    assert S.kv_layout(cfg, 4, 32, grid, "tp2d") == "seq"
    assert S.kv_layout(cfg, 4, 32, grid, "dp_replicated") == "whole"


@pytest.mark.parametrize("shape,names", [((1, 3), ("data", "model")),
                                         ((2, 3), ("data", "model")),
                                         ((2, 16, 16),
                                          ("pod", "data", "model"))])
@pytest.mark.parametrize("batch", [1, 2, 6, 12, 32, 512])
def test_dp_replicated_rows_follow_batch_specs(shape, names, batch):
    """Under 'dp_replicated' a rank's rows are its block of the axes
    `batch_specs` splits the batch over (every axis where they divide
    it, else the DP axes), as rank order lays them out."""
    spec = RS.batch_specs(
        {"x": jax.ShapeDtypeStruct((batch, 4), np.int32)}, _mesh(shape, names),
        "dp_replicated")["x"]
    axes = spec[0] if spec else None
    axes = (axes,) if isinstance(axes, str) else axes
    size = int(np.prod(shape))
    for rank in range(size):
        g = S.Grid(tuple(names), tuple(shape), rank=rank)
        lo, n = S.local_batch(batch, g, "dp_replicated")
        if axes is None:
            assert (lo, n) == (0, batch)
            continue
        ways = int(np.prod([dict(zip(names, shape))[a] for a in axes]))
        if axes == tuple(names):
            at = rank
        elif axes == tuple(a for a in names if a != "model"):
            at = g.data_rank
        else:                      # "pod" alone: the port leaves it whole
            assert (lo, n) == (0, batch)
            continue
        assert (lo, n) == (at * (batch // ways), batch // ways)


def test_local_batch_follows_batch_specs():
    grid = S.grid((2, 2), ("data", "model"))
    g1 = S.Grid(grid.axis_names, grid.sizes, rank=3)
    assert S.local_batch(4, g1) == (2, 2)
    assert S.local_batch(3, g1) == (0, 3)
    assert S.local_batch(1, g1) == (0, 1)
    assert S.local_batch(4, S.grid((1, 2), ("data", "model"))) == (0, 4)
