"""The port's roofline accounting (`repro_torch.roofline.op_cost`,
`analysis`, `explain`): the counterparts of `tests/test_roofline.py`'s
cases on small torch programs with hand-computed answers, and the
kernel wrappers' `meta` route and reports to the walk."""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.parallel import tp
from repro_torch.roofline.analysis import analyze
from repro_torch.roofline.explain import explain
from repro_torch.roofline.kernels import k4_bound, membership_bound
from repro_torch.roofline.op_cost import OpCost


def test_matmul_loop_counts_every_trip():
    a = torch.empty(128, 256, device="meta")
    b = torch.empty(256, 128, device="meta")
    with OpCost() as rec:
        for _ in range(10):
            a @ b
    assert rec.flops == 10 * 2 * 128 * 128 * 256
    # each trip reads both operands and writes the product
    assert rec.bytes_ == 10 * 4 * (128 * 256 + 256 * 128 + 128 * 128)


def test_einsum_and_inference_mode_matmuls_count():
    x = torch.empty(2, 8, 16, device="meta")
    w = torch.empty(16, 32, device="meta")
    with torch.inference_mode(), OpCost() as rec:
        x @ w                                   # matmul, a composite
        torch.einsum("bsd,de->bse", x, w)
    assert rec.flops == 2 * (2 * 2 * 8 * 16 * 32)


def test_embedding_bills_window_not_table():
    table = torch.empty(1000, 64)
    idx = torch.arange(8, dtype=torch.int32)
    with OpCost() as rec:
        torch.nn.functional.embedding(idx, table)
    # reads the gathered window and the indices, writes the window
    assert rec.bytes_ == (8 * 64 * 4 + 8 * 4) + 8 * 64 * 4


def test_index_select_and_gather_bill_the_window():
    table = torch.empty(1000, 64, device="meta")
    idx = torch.zeros(8, dtype=torch.int64, device="meta")
    with OpCost() as rec:
        table.index_select(0, idx)
    assert rec.bytes_ == (8 * 64 * 4 + 8 * 8) + 8 * 64 * 4


def test_cache_update_bills_the_update_not_the_buffer():
    cache = torch.zeros(1000, 64)
    row = torch.ones(1, 64)
    with OpCost() as rec:
        cache[5:6] = row                         # slice + copy_
    assert rec.bytes_ == 64 * 4 + 64 * 4
    pos = torch.tensor([7])
    with OpCost() as rec:
        cache.index_copy_(0, pos, row)
    assert rec.bytes_ == 64 * 4 + 8 + 64 * 4
    with OpCost() as rec:
        cache[pos] = row                         # index_put_
    assert rec.bytes_ == 64 * 4 + 8 + 64 * 4
    assert torch.equal(cache[7], row[0]) and torch.equal(cache[5], row[0])


def test_view_ops_bill_nothing():
    x = torch.empty(4, 6, 8, device="meta")
    with OpCost() as rec:
        x.view(24, 8).t()
        x.transpose(0, 1).permute(2, 0, 1)
        x[1:3, :, ::2].select(0, 1).unsqueeze(0).squeeze(0)
        x.reshape(4, 48).expand(2, 4, 48)
        x.detach().as_strided((2, 2), (1, 1))
        x.narrow(2, 0, 4).unbind(0)
        torch.empty(1 << 20, device="meta")
    assert rec.bytes_ == 0 and rec.flops == 0 and not rec.by_sig


def test_all_reduce_is_ring_factored():
    from repro_torch.launch import dryrun

    with dryrun.fake_world(256):
        grid = dryrun.production_grid("single")
        x = torch.empty(128, 128, device="meta")
        with tp.using(tp.Ctx(grid, None)), OpCost(grid) as rec:
            for _ in range(10):
                tp.all_reduce(x)
    assert rec.coll == {"all-reduce": 10 * 2 * 128 * 128 * 4}
    # the copy `tp._reduce` reduces (never `x` itself) is memory traffic;
    # the collective is not
    assert rec.bytes_ == 10 * 2 * 128 * 128 * 4
    assert set(rec.by_sig) == {"clone -> float32[128, 128]"}


def test_all_gather_is_billed_its_result():
    from repro_torch.launch import dryrun

    with dryrun.fake_world(256):
        grid = dryrun.production_grid("single")
        x = torch.empty(4, 8, device="meta")
        with tp.using(tp.Ctx(grid, None)), OpCost(grid) as rec:
            y = tp.all_gather(x, dim=1)
    assert y.shape == (4, 8 * 16)
    assert rec.coll == {"all-gather": 16 * 4 * 8 * 4}


def test_peak_is_arguments_plus_the_high_water_mark():
    a = torch.empty(64, 128, device="meta")
    b = torch.empty(128, 256, device="meta")
    c = torch.empty(256, 32, device="meta")
    rec = OpCost()
    rec.hold(a, b, c)
    with rec:
        z = (a @ b) @ c      # a@b (64x256) is alive while z (64x32) is made
        del z
        a @ c[:128]          # 64x32, after both are gone
    assert rec.args_bytes == 4 * (64 * 128 + 128 * 256 + 256 * 32)
    assert rec.high == 4 * (64 * 256 + 64 * 32)
    assert rec.peak_bytes == rec.args_bytes + rec.high
    assert rec.live == 0


def test_explain_prints_the_table():
    a = torch.empty(128, 256, device="meta")
    with OpCost() as rec:
        (a @ a.t()).relu()
    txt = explain(rec, top=5)
    assert txt.startswith("total bytes=")
    assert "total flops=" in txt
    assert "mm -> float32[128, 128]" in txt and "relu" in txt


def test_analyze_terms():
    a = torch.empty(512, 512, device="meta")
    with OpCost() as rec:
        a @ a
    r = analyze("x", "s", "single", 256, rec, model_flops=256 * 2 * 512 ** 3)
    d = r.to_json()
    assert d["flops_per_device"] == 2 * 512 ** 3
    assert d["useful_flops_ratio"] == 1.0
    assert d["bottleneck"] == "memory"
    assert "raw_cost_flops" not in d
    assert d["step_time_s"] == max(d["compute_s"], d["memory_s"],
                                   d["collective_s"])


# ------------------------------------------------ kernels in the walk --
def test_route_names_meta():
    assert ops._route(torch.device("meta")) == "meta"


@pytest.mark.parametrize("causal", [True, False])
def test_flash_reports_its_bound_on_meta_and_cpu(causal):
    shape = (8, 4, 64, 64, 32)
    BH, BK, Sq, Sk, hd = shape
    b = k4_bound(shape, causal, elem=4)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(n, s, hd, generator=g)
               for n, s in ((BH, Sq), (BK, Sk), (BK, Sk)))
    for dev in ("meta", "cpu"):
        qd, kd, vd = q.to(dev), k.to(dev), v.to(dev)
        with OpCost() as rec:
            out = ops.flash_attention_rows(qd, kd, vd, causal=causal)
        assert out.shape == q.shape and out.device.type == dev
        assert dict(rec.kernels) == {"flash": 1}
        # the kernel's work, never the plain version's [BH, S, S] scores
        assert (rec.flops, rec.bytes_) == (b.ops, b.nbytes)
    assert torch.equal(out, flash_attention_ref(q, k, v, causal=causal))
    assert ops.launches["flash"] == 0


@pytest.mark.parametrize("count", [False, True])
def test_membership_meta_route(count):
    cand = torch.empty(16, 8, dtype=torch.int32, device="meta")
    nbr = torch.empty(16, 32, dtype=torch.int32, device="meta")
    fn = ops.intersect_count if count else ops.sorted_membership
    with OpCost() as rec:
        out = fn(cand, nbr)
    assert out.shape == ((16,) if count else (16, 8))
    assert out.dtype == (torch.int32 if count else torch.bool)
    key = "intersect_count" if count else "membership"
    b = membership_bound(16, 8, 32, count)
    assert dict(rec.kernels) == {key: 1}
    assert (rec.bytes_, rec.compares) == (b.nbytes, b.ops)


def test_k1_refuses_meta():
    m = torch.empty(4, 3, dtype=torch.int32, device="meta")
    flat = torch.empty(10, dtype=torch.int32, device="meta")
    sl = torch.empty(1, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta tensors hold none"):
        ops.level_expand(m, flat, sl, sl, window=4)


def test_no_walk_no_report():
    q = torch.randn(2, 16, 8)
    ops.flash_attention_rows(q, q, q)        # nothing active: no error
