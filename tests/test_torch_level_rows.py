"""Port parity for K1's row-sourced count and signed mode
(`repro_torch.kernels.ops.level_expand_rows`): on CPU tensors the wrapper
runs its plain version, which must equal the reference's
`repro.kernels.ops.level_expand` (its Pallas kernel in interpret mode, and
its oracle `repro.kernels.ref.level_expand_ref`) on the window gathered
from the same candidate rows, with the prefix columns appended in signed
mode.  No tolerance: counts are int32.

The executor's counting levels and IEP tail go through this entry on the
kernel path; a spy shows the routing on tiny-er.  The CUDA kernel itself
runs only on a card (tests/test_torch_cuda_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref

from repro_torch.kernels import ops
from repro_torch.kernels import ref as port_ref

from test_torch_cuda_kernels import rows_case

torch.set_num_threads(1)

DIRS = {"none": (), "gt": (1,), "gt_lt_ne": (1, -1, 0), "ne_ne": (0, 0)}


def _window(case, dirs, signed):
    """The reference's inputs, gathered in numpy: the candidate window
    at `width` (indices clamped to the array's end, columns past clen
    invalid), the prefix columns appended in signed mode, row lengths
    cut to `window` (the reference's contract is window >= every row)."""
    width = case["width"]
    cols = np.arange(width)
    idx = np.minimum(case["cstart"][:, None] + cols[None, :],
                     len(case["csrc"]) - 1)
    cand = case["csrc"][idx]
    valid = cols[None, :] < case["clen"][:, None]
    if signed:
        cand = np.concatenate([cand, case["neg"]], axis=1)
        valid = np.concatenate([valid, np.ones(case["neg"].shape, bool)],
                               axis=1)
    extra = case["extra"][:, :len(dirs)] if dirs else None
    lens = np.minimum(case["lens"], case["window"])
    return (np.ascontiguousarray(cand), case["flat"], case["starts"], lens,
            None if extra is None else np.ascontiguousarray(extra), valid)


def _port(case, dirs, signed, own=True):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         case.items() if isinstance(v, np.ndarray)}
    return ops.level_expand_rows(
        t["csrc"], t["cstart"], t["clen"], t["flat"], t["starts"],
        t["lens"], t["own"] if own else None,
        t["extra"][:, :len(dirs)].contiguous() if dirs else None,
        t["neg"] if signed else None, dirs=dirs, width=case["width"],
        window=case["window"]).numpy()


def _ref_kw(case, dirs, signed):
    return dict(dirs=dirs, count=True, window=case["window"],
                neg_from=case["width"] if signed else None)


@pytest.mark.parametrize("P,label,signed", [
    (1, False, True), (2, False, False), (2, True, True), (3, False, True),
    (4, True, False)])
def test_rows_plain_matches_pallas_interpret(P, label, signed):
    """Against the reference's Pallas kernel itself (interpret mode), on
    small cases: count and signed, a labeled candidate source, P = 1-4
    (P = 1 with only the own row and the prefix columns)."""
    case = rows_case(30 + P, 10, P, width=20, window=28, L=30,
                     Q=3 if signed else 0, label=label)
    dirs = DIRS["gt_lt_ne"] if P % 2 else DIRS["ne_ne"]
    got = _port(case, dirs, signed)
    want = ref_ops.level_expand(*_window(case, dirs, signed),
                                interpret=True, **_ref_kw(case, dirs, signed))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("label", [False, True], ids=["csr", "labeled"])
@pytest.mark.parametrize("mode", ["count", "signed"])
def test_rows_plain_matches_reference_oracle(P, label, mode):
    """Against the reference's oracle on the gathered window: rows past
    `window`, empty candidate and predecessor rows, every comparison
    set (ranges empty, partial and whole), `own` given and not, prefix
    values inside, outside and duplicated in the rows."""
    signed = mode == "signed"
    case = rows_case(P * 7 + label, 40, P, width=48, window=60, L=90,
                     Q=4 if signed else 0, label=label)
    assert (case["lens"] > case["window"]).any()
    assert (case["clen"] == 0).any() and (case["own"] == -1).any()
    for dirs in DIRS.values():
        want = np.asarray(ref_ref.level_expand_ref(
            *_window(case, dirs, signed), **_ref_kw(case, dirs, signed)))
        for own in (True, False):
            np.testing.assert_array_equal(_port(case, dirs, signed, own),
                                          want)


def test_rows_signed_counts_prefix_columns_negatively():
    """A prefix vertex in every row counts -1; duplicated, it counts
    twice; one outside a row, or failing a comparison, counts nothing."""
    flat = torch.tensor([1, 3, 5, 7, 3, 5, 9], dtype=torch.int32)
    starts = torch.tensor([[0], [4]], dtype=torch.int32)
    lens = torch.tensor([[4], [3]], dtype=torch.int32)
    one = torch.tensor([0], dtype=torch.int32)
    four = torch.tensor([4], dtype=torch.int32)
    kw = dict(width=8, window=8)
    # candidates = row 0; in row 1 too: 3, 5
    assert ops.level_expand_rows(flat, one, four, flat, starts, lens,
                                 one, **kw).tolist() == [2]
    neg = torch.tensor([[5, 5, 7, 9]], dtype=torch.int32)
    assert ops.level_expand_rows(flat, one, four, flat, starts, lens, one,
                                 neg=neg, **kw).tolist() == [0]
    extra = torch.tensor([[4]], dtype=torch.int32)        # c > 4
    assert ops.level_expand_rows(flat, one, four, flat, starts, lens, one,
                                 extra, neg, dirs=(1,), **kw).tolist() == [-1]


def test_rows_cpu_calls_do_not_count_launches():
    ops.reset_launches()
    case = rows_case(0, 20, 2, width=16, window=20, L=24, Q=2)
    _port(case, (1, -1, 0), True)
    _port(case, (), False)
    assert not any(ops.launches.values())


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "device",
                                 "own_low", "own_high", "extra", "neg"])
def test_rows_wrapper_rejects_bad_inputs(bad):
    case = rows_case(1, 12, 2, width=16, window=20, L=24, Q=2)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         case.items() if isinstance(v, np.ndarray)}
    kw = dict(dirs=(1, -1, 0), width=16, window=20)
    extra = t["extra"]
    if bad == "dtype":
        t["cstart"] = t["cstart"].to(torch.int64)
    elif bad == "contiguity":
        t["starts"] = torch.cat([t["starts"], t["starts"]], 1)[:, ::2]
    elif bad == "shape":
        t["clen"] = t["clen"][:-1].contiguous()
    elif bad == "device":
        t["lens"] = torch.empty(t["lens"].shape, dtype=torch.int32,
                                device="meta")
    elif bad == "own_low":
        t["own"][3] = -2
    elif bad == "own_high":
        t["own"][5] = 2
    elif bad == "extra":
        extra = None
    else:
        t["neg"] = t["neg"][:, 0]
    with pytest.raises((TypeError, ValueError)):
        ops.level_expand_rows(t["csrc"], t["cstart"], t["clen"], t["flat"],
                              t["starts"], t["lens"], t["own"], extra,
                              t["neg"], **kw)


# K1 launches per mode of the tiny-er P1 counts below, from the executor
# before this entry existed (gathered window + `level_expand` in every
# mode), at capacity 2,048 with the launches counted as on a card.  Count
# launches are only those of the 23 of 45 dispatches that are counted:
# the others overflow and skip their last level.
PARENT_LAUNCHES = {("graphpi", False): {"mask": 45, "count": 23},
                   ("graphzero", True): {"mask": 88, "signed": 88}}


@pytest.mark.parametrize("mode,iep", list(PARENT_LAUNCHES),
                         ids=["graphpi", "graphzero-iep"])
def test_counts_route_through_the_rows_entry(monkeypatch, mode, iep):
    """On the kernel path, count and signed launches go through
    `level_expand_rows` and mask launches through
    `level_expand_compact` (none through the gathered-window
    `level_expand`), each launch counted as on a card (the route is
    forced to the kernel and the CUDA launchers stubbed with the plain
    versions), and the per-mode numbers equal the executor's before
    this entry (count launches less those of the dispatches whose count
    is thrown away)."""
    from repro_torch.configs.graphpi import get_dataset, get_pattern
    from repro_torch.core.executor import (ExecutorConfig, Matcher,
                                           auto_buckets, compute_stats)
    from repro_torch.query.cache import plan_for

    calls = {"level_expand": set(), "level_expand_rows": set(),
             "level_expand_compact": set()}
    mode_of = {
        "level_expand": lambda a, kw: (
            "mask" if not kw.get("count") else
            "count" if kw.get("neg_from") is None else "signed"),
        "level_expand_compact": lambda a, kw: "mask",
        "level_expand_rows": lambda a, kw: (
            "count" if (a[8] if len(a) > 8 else kw.get("neg")) is None
            else "signed"),
    }

    def spy(name, real):
        def wrapped(*a, **kw):
            calls[name].add(mode_of[name](a, kw))
            return real(*a, **kw)
        return wrapped

    monkeypatch.setattr(ops, "_route", lambda device: "kernel")
    monkeypatch.setattr(ops, "level_expand_cuda", port_ref.level_expand_ref)
    monkeypatch.setattr(
        ops, "level_rows_cuda",
        lambda *a, dirs, width, window: port_ref.level_expand_rows_ref(
            *a, dirs=dirs, width=width, window=window))
    monkeypatch.setattr(
        ops, "level_compact_cuda",
        lambda *a, dirs, width, window: port_ref.level_expand_compact_ref(
            *a, dirs=dirs, width=width, window=window))
    for name in calls:
        monkeypatch.setattr(ops, name, spy(name, getattr(ops, name)))
    graph = get_dataset("tiny-er")
    cfg = ExecutorConfig(capacity=2048, degree_buckets=auto_buckets(graph))
    stats = compute_stats(graph, cfg, device="cpu")
    _, plan = plan_for(get_pattern("P1"), stats, mode=mode, use_iep=iep)
    for name in calls:
        calls[name].clear()
    ops.reset_launches()
    res = Matcher(graph, plan, cfg, device="cpu").count()
    assert res.count == 27_358
    assert {k: v for k, v in ops.launches.items() if v} \
        == PARENT_LAUNCHES[(mode, iep)]
    assert calls == {"level_expand": set(),
                     "level_expand_compact": {"mask"},
                     "level_expand_rows": {"signed" if iep else "count"}}
