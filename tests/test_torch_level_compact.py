"""Port parity for K1's mask mode with the level's stream compaction
(`repro_torch.kernels.ops.level_expand_compact`): on CPU tensors the
wrapper runs its plain version, which must equal the reference's mask
(`repro.kernels.ops.level_expand` in mask mode: its Pallas kernel in
interpret mode, and its oracle `repro.kernels.ref.level_expand_ref`) on
the window gathered from the same candidate rows, followed by the
reference executor's stream compaction (`repro/core/executor.py:
390-398`, written out in jnp below) — exactly over parent[:C],
newcol[:C] and the offset.  No tolerance: everything is an integer.

The executor's inner levels go through this entry on the kernel path; a
spy shows the routing on tiny-er.  The CUDA kernels themselves run only
on a card (tests/test_torch_cuda_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref

from repro_torch.kernels import intersect, ops
from repro_torch.kernels import ref as port_ref

from test_torch_cuda_kernels import rows_case
from test_torch_level_rows import DIRS, _window

torch.set_num_threads(1)


def ref_compact(mask, cand, rows, offset, parent, newcol):
    """The reference executor's compaction (`repro/core/executor.py:
    390-398`) on one level's mask: pairs in (row, column) order behind
    `offset`, positions past C into the slot C, the offset advanced by
    the total.  In int64, as the reference counts under its x64 switch."""
    with enable_x64():
        C = parent.shape[0] - 1
        B, D = mask.shape
        flat_mask = jnp.asarray(mask).reshape(-1)
        pos = jnp.cumsum(flat_mask, dtype=jnp.int64) - 1
        total = pos[-1] + 1
        out_idx = jnp.where(flat_mask, jnp.minimum(offset + pos, C), C)
        rows_local = jnp.arange(B * D, dtype=jnp.int32) // D
        parent = jnp.asarray(parent).at[out_idx].set(
            jnp.take(jnp.asarray(rows), rows_local), mode="drop")
        newcol = jnp.asarray(newcol).at[out_idx].set(
            jnp.asarray(cand).reshape(-1), mode="drop")
        return (np.asarray(parent)[:C], np.asarray(newcol)[:C],
                int(offset + total))


def _rows(B):
    return (np.arange(B, dtype=np.int32) * 7 + 3) % 1000


def port_compact(case, dirs, C, offset0, own=True):
    """The port's entry on CPU tensors: (parent[:C], newcol[:C], offset)
    after one call into buffers filled with -7."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         case.items() if isinstance(v, np.ndarray)}
    parent = torch.full((C + 1,), -7, dtype=torch.int32)
    newcol = torch.full((C + 1,), -7, dtype=torch.int32)
    offset = torch.tensor(offset0, dtype=torch.int64)
    ops.level_expand_compact(
        t["csrc"], t["cstart"], t["clen"], t["flat"], t["starts"],
        t["lens"], t["own"] if own else None,
        t["extra"][:, :len(dirs)].contiguous() if dirs else None,
        torch.from_numpy(_rows(len(case["cstart"]))), offset, parent, newcol,
        dirs=dirs, width=case["width"], window=case["window"])
    return parent[:C].numpy(), newcol[:C].numpy(), int(offset)


def settings(total):
    """(C, starting offset): every pair kept; totals past C; an offset
    that starts just below C; an offset above 2^31 - C (all dropped)."""
    half = max(total // 2, 1)
    return [(total + 5, 0), (half, 2), (half, max(half - 3, 0)),
            (max(total, 1), 2**31 - max(total, 1) + 4)]


def _check(case, dirs, mask, own=True, which=None):
    """Port against the reference on one mask, at every C / offset
    setting, or only at setting `which`."""
    cand = _window(case, dirs, False)[0]
    rows = _rows(len(case["cstart"]))
    mask = np.asarray(mask)
    total = int(mask.sum())
    todo = settings(total)
    for C, off0 in todo if which is None else [todo[which % len(todo)]]:
        init = np.full(C + 1, -7, np.int32)
        want = ref_compact(mask, cand, rows, off0, init, init)
        got = port_compact(case, dirs, C, off0, own)
        assert got[2] == want[2] == off0 + total
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("P,label", [(1, False), (2, True), (3, False),
                                     (4, True)])
def test_compact_plain_matches_pallas_interpret(P, label):
    """Against the reference's Pallas kernel itself (interpret mode) in
    mask mode, then its compaction: P = 1-4, CSR and labeled candidate
    rows, comparisons, each C / offset setting."""
    case = rows_case(50 + P, 10, P, width=20, window=28, L=30, label=label)
    dirs = DIRS["gt_lt_ne"] if P % 2 else DIRS["ne_ne"]
    mask = ref_ops.level_expand(*_window(case, dirs, False), interpret=True,
                                dirs=dirs, count=False,
                                window=case["window"])
    _check(case, dirs, mask)


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("label", [False, True], ids=["csr", "labeled"])
def test_compact_plain_matches_reference_oracle(P, label):
    """Against the reference's oracle mask, then its compaction: rows
    past `window`, empty candidate and predecessor rows, every
    comparison set, own given and not; the C / offset settings taken in
    turn."""
    case = rows_case(P * 11 + label, 40, P, width=48, window=60, L=90,
                     label=label)
    assert (case["clen"] == 0).any() and (case["own"] == -1).any()
    for i, dirs in enumerate(DIRS.values()):
        mask = ref_ref.level_expand_ref(*_window(case, dirs, False),
                                        dirs=dirs, count=False,
                                        window=case["window"])
        for own in (True, False):
            _check(case, dirs, mask, own, which=2 * i + own + P)


def test_compact_equals_the_executors_composition():
    """The plain version is, bit for bit, the composition the executor
    ran before it: the gathered window, `level_expand_ref` in mask mode,
    `compact_pairs`; repeated calls append behind the running offset."""
    case = rows_case(3, 30, 3, width=32, window=40, L=50)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         case.items() if isinstance(v, np.ndarray)}
    rows = torch.from_numpy(_rows(30))
    kw = dict(dirs=(1, 0), window=40)
    ex = t["extra"][:, :2].contiguous()
    out = []
    for entry in (True, False):
        parent = torch.zeros(61, dtype=torch.int32)
        newcol = torch.zeros(61, dtype=torch.int32)
        offset = torch.tensor(4, dtype=torch.int64)
        for _ in range(3):
            if entry:
                ops.level_expand_compact(
                    t["csrc"], t["cstart"], t["clen"], t["flat"],
                    t["starts"], t["lens"], t["own"], ex, rows, offset,
                    parent, newcol, width=32, **kw)
            else:
                cand, ok = port_ref.gather_window(t["csrc"], t["cstart"],
                                                  t["clen"], 32)
                mask = port_ref.level_expand_ref(
                    cand, t["flat"], t["starts"], t["lens"], ex, ok, **kw)
                port_ref.compact_pairs(mask, cand, rows, offset, parent,
                                       newcol)
        out.append((parent[:60], newcol[:60], int(offset)))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert out[0][2] == out[1][2] > 60        # the third call overflowed


def test_compact_cpu_calls_do_not_count_launches():
    ops.reset_launches()
    case = rows_case(0, 20, 2, width=16, window=20, L=24)
    port_compact(case, (1, -1, 0), 100, 0)
    port_compact(case, (), 3, 1)
    assert not any(ops.launches.values())
    assert not any(intersect.compact_launches.values())


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "device",
                                 "own", "extra", "rows", "offset_dtype",
                                 "offset_shape", "newcol", "parent"])
def test_compact_wrapper_rejects_bad_inputs(bad):
    case = rows_case(1, 12, 2, width=16, window=20, L=24)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         case.items() if isinstance(v, np.ndarray)}
    extra = t["extra"]
    rows = torch.arange(12, dtype=torch.int32)
    offset = torch.zeros((), dtype=torch.int64)
    parent = torch.zeros(31, dtype=torch.int32)
    newcol = torch.zeros(31, dtype=torch.int32)
    if bad == "dtype":
        t["cstart"] = t["cstart"].to(torch.int64)
    elif bad == "contiguity":
        t["starts"] = torch.cat([t["starts"], t["starts"]], 1)[:, ::2]
    elif bad == "shape":
        t["clen"] = t["clen"][:-1].contiguous()
    elif bad == "device":
        t["lens"] = torch.empty(t["lens"].shape, dtype=torch.int32,
                                device="meta")
    elif bad == "own":
        t["own"][5] = 2
    elif bad == "extra":
        extra = None
    elif bad == "rows":
        rows = rows[:-1]
    elif bad == "offset_dtype":
        offset = offset.to(torch.int32)
    elif bad == "offset_shape":
        offset = offset.reshape(1)
    elif bad == "newcol":
        newcol = newcol[:-1]
    else:
        parent = torch.zeros((31, 1), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        ops.level_expand_compact(
            t["csrc"], t["cstart"], t["clen"], t["flat"], t["starts"],
            t["lens"], t["own"], extra, rows, offset, parent, newcol,
            dirs=(1, -1, 0), width=16, window=20)


# K1 launches per mode of the tiny-er counts below, from the executor
# before this entry existed (the gathered window, `level_expand` in mask
# mode and the compaction in plain PyTorch), at capacity 8,192 (the
# graphzero and naive counts overflow it and bisect) with the launches
# counted as on a card.  Count launches are only those of the dispatches
# that are counted: one whose count the chunk loop throws away (split or
# escalated) skips its last level once its demand overflows (P1 graphpi:
# 5 of 11 dispatches, naive: 10 of 21; P4 graphpi: 4 of 9).
PARENT_LAUNCHES = {
    ("P1", "graphpi", False): {"mask": 11, "count": 6},
    ("P1", "graphzero", True): {"mask": 19, "signed": 19},
    ("P1", "naive", False): {"mask": 21, "count": 11},
    ("P4", "graphpi", False): {"mask": 9, "count": 5},
    ("P4", "graphzero", True): {"signed": 9},
    ("P4", "naive", False): {"mask": 21, "count": 11}}
COUNTS = {"P1": 27_358, "P4": 4_225}


@pytest.fixture(scope="module")
def tiny_er():
    """tiny-er, the executor configuration of the counts below and its
    statistics (the triangle count), computed once for the module."""
    from repro_torch.configs.graphpi import get_dataset
    from repro_torch.core.executor import (ExecutorConfig, auto_buckets,
                                           compute_stats)

    graph = get_dataset("tiny-er")
    cfg = ExecutorConfig(capacity=8192, degree_buckets=auto_buckets(graph))
    return graph, cfg, compute_stats(graph, cfg, device="cpu")


@pytest.mark.parametrize("pattern,mode,iep", list(PARENT_LAUNCHES),
                         ids=lambda v: str(v))
def test_mask_levels_route_through_the_compact_entry(monkeypatch, tiny_er,
                                                     pattern, mode, iep):
    """On the kernel path every mask launch goes through
    `level_expand_compact` and none through the gathered-window
    `level_expand`, each launch counted as on a card (the route forced
    to the kernel, the CUDA launchers stubbed with the plain versions);
    the per-mode launch numbers equal the executor's before this entry
    (count launches less those of the dispatches whose count is thrown
    away), and the counts the oracle's."""
    from repro_torch.configs.graphpi import get_pattern
    from repro_torch.core.executor import Matcher
    from repro_torch.query.cache import plan_for

    calls = {"level_expand": 0, "level_expand_compact": 0}

    def spy(name, real):
        def wrapped(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return wrapped

    def plain(fn):
        return lambda *a, dirs, width, window: fn(*a, dirs=dirs, width=width,
                                                  window=window)

    monkeypatch.setattr(ops, "_route", lambda device: "kernel")
    monkeypatch.setattr(ops, "level_expand_cuda", port_ref.level_expand_ref)
    monkeypatch.setattr(ops, "level_rows_cuda",
                        plain(port_ref.level_expand_rows_ref))
    monkeypatch.setattr(ops, "level_compact_cuda",
                        plain(port_ref.level_expand_compact_ref))
    for name in calls:
        monkeypatch.setattr(ops, name, spy(name, getattr(ops, name)))
    graph, cfg, stats = tiny_er
    pat = get_pattern(pattern)
    _, plan = plan_for(pat, stats, mode=mode, use_iep=iep)
    for name in calls:
        calls[name] = 0
    ops.reset_launches()
    res = Matcher(graph, plan, cfg, device="cpu").count()
    div = pat.aut_count() if mode == "naive" else 1
    assert res.count // div == COUNTS[pattern]
    launches = {k: v for k, v in ops.launches.items() if v}
    assert launches == PARENT_LAUNCHES[(pattern, mode, iep)]
    assert calls == {"level_expand": 0,
                     "level_expand_compact": launches.get("mask", 0)}
