"""The kernels' bounds in `repro_torch.roofline.kernels` (moved there
from `chip_smoke.py`) return what `chip_smoke.py` computed before the
move, on small fixed inputs, and the bytes and operations they counted
give their time."""
import pytest
import torch

from repro_torch.launch.mesh import HW
from repro_torch.roofline.kernels import (Bound, bound_of, k4_bound,
                                          membership_bound, rows_bound_of)


def _inputs():
    g = torch.Generator().manual_seed(3)
    flat = torch.sort(torch.randint(0, 50, (200,), generator=g)).values.to(
        torch.int32)
    B, D = 6, 5
    cand = torch.randint(0, 50, (B, D), generator=g, dtype=torch.int32)
    starts = torch.tensor([[0, 10, 10, 40, 0, 90], [20, 20, 60, 40, 0, 100]],
                          dtype=torch.int32)
    lens = torch.tensor([[7, 9, 9, 12, 7, 3], [5, 5, 0, 12, 7, 30]],
                        dtype=torch.int32)
    extra = torch.randint(0, 50, (B, 2), generator=g, dtype=torch.int32)
    valid = torch.rand((B, D), generator=g) < 0.7
    cstart = torch.tensor([0, 30, 60, 90, 120, 150], dtype=torch.int32)
    clen = torch.tensor([4, 9, 0, 12, 3, 20], dtype=torch.int32)
    own = torch.tensor([0, -1, 1, 0, -1, 1], dtype=torch.int32)
    neg = torch.randint(0, 50, (B, 3), generator=g, dtype=torch.int32)
    return dict(flat=flat, cand=cand, starts=starts, lens=lens, extra=extra,
                valid=valid, cstart=cstart, clen=clen, own=own, neg=neg)


def _consistent(b: Bound, rate: float) -> None:
    t_bytes = b.nbytes / HW["hbm_bw"] * 1e3
    t_ops = b.ops / rate * 1e3
    assert b.ms == max(t_bytes, t_ops)
    assert b.by == ("bytes" if t_bytes >= t_ops else "operations")


# (count, without extra/valid) -> chip_smoke.bound_of's ms, all "bytes"
WINDOW = {(False, False): 1.4925373134328358e-07,
          (False, True): 1.2597014925373136e-07,
          (True, False): 1.4746268656716418e-07,
          (True, True): 1.2417910447761194e-07}


@pytest.mark.parametrize("count,bare", list(WINDOW))
def test_bound_of_as_before(count, bare):
    a = _inputs()
    b = bound_of(a["cand"], a["starts"], a["lens"],
                 None if bare else a["extra"], None if bare else a["valid"],
                 count, 10)
    assert b[:2] == (WINDOW[count, bare], "bytes")
    _consistent(b, HW["peak_flops_fp32"])


# (no own, no neg, dirs, written) -> chip_smoke.rows_bound_of's ms
ROWS = {
    (False, True, (1, 0), None): 1.4925373134328358e-07,
    (False, True, (1, 0), 17): 1.898507462686567e-07,
    (False, True, (), None): 1.3492537313432836e-07,
    (False, True, (), 17): 1.7552238805970148e-07,
    (False, False, (1, 0), None): 1.826865671641791e-07,
    (False, False, (1, 0), 17): 2.2328358208955224e-07,
    (False, False, (), None): 1.6835820895522387e-07,
    (False, False, (), 17): 2.0895522388059702e-07,
    (True, True, (1, 0), None): 1.5402985074626866e-07,
    (True, True, (1, 0), 17): 1.9462686567164178e-07,
    (True, True, (), None): 1.3970149253731344e-07,
    (True, True, (), 17): 1.8029850746268656e-07,
    (True, False, (1, 0), None): 1.7552238805970148e-07,
    (True, False, (1, 0), 17): 2.1611940298507463e-07,
    (True, False, (), None): 1.6119402985074627e-07,
    (True, False, (), 17): 2.0179104477611939e-07,
}


@pytest.mark.parametrize("no_own,no_neg,dirs,written", list(ROWS))
def test_rows_bound_of_as_before(no_own, no_neg, dirs, written):
    a = _inputs()
    b = rows_bound_of(a["flat"], a["cstart"], a["clen"], a["flat"],
                      a["starts"], a["lens"], None if no_own else a["own"],
                      a["extra"] if dirs else None,
                      None if no_neg else a["neg"], dirs=dirs, width=8,
                      window=10, written=written)
    assert b[:2] == (ROWS[no_own, no_neg, dirs, written], "bytes")
    _consistent(b, HW["peak_flops_fp32"])


def test_rows_bound_of_shared_rows_is_bound_by_operations():
    B = 4096
    flat = torch.arange(0, 3000, dtype=torch.int32)
    starts = torch.stack([torch.full((B,), 1000, dtype=torch.int32),
                          torch.full((B,), 2000, dtype=torch.int32)])
    b = rows_bound_of(flat, torch.zeros(B, dtype=torch.int32),
                      torch.full((B,), 128, dtype=torch.int32), flat, starts,
                      torch.full((2, B), 1000, dtype=torch.int32), None, None,
                      None, dirs=(), width=128, window=1000)
    assert b == (0.0001565038805970149, "operations", 10485760.0, 123200)
    _consistent(b, HW["peak_flops_fp32"])


@pytest.mark.parametrize("shape,causal,want", [
    ((64, 32, 2048, 2048, 128), True,
     (0.06951772615571283, "operations", 68753031168.0, 100663296)),
    ((16, 16, 2048, 2048, 64), False,
     (0.017370949629929223, "operations", 17179869184.0, 16777216)),
    ((6, 3, 1000, 777, 128), True,
     (0.0015546370070778565, "operations", 1537536000.0, 4265472)),
])
def test_k4_bound_as_before(shape, causal, want):
    b = k4_bound(shape, causal)
    assert tuple(b) == want
    _consistent(b, HW["peak_flops_bf16"])
    # fp32 rows move twice the bytes, the same FLOP
    b32 = k4_bound(shape, causal, elem=4)
    assert (b32.ops, b32.nbytes) == (b.ops, 2 * b.nbytes)


@pytest.mark.parametrize("args,want", [
    ((65536, 1024, 1024, False), 0.1802924704477612),
    ((65536, 1024, 1000, True), 0.1584601791044776),
    ((8, 128, 128, True, True), 2.7701492537313433e-06),
])
def test_membership_bound_as_before(args, want):
    b = membership_bound(*args)
    assert b[:2] == (want, "bytes")
    _consistent(b, HW["peak_flops_fp32"])
