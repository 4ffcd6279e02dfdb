"""The port's tracer on the profiler's clock: a span and a
`torch.profiler.record_function` range opened together start together
in both records, and the range lies inside the span, within 1 ms on
the CPU and within 0.1 ms on the card (test marked `cuda`); the
Chrome export carries the same starts, and `obs summarize` reads it.

    PYTHONPATH=src python -m pytest -q tests/test_torch_obs_trace.py
"""
import statistics

import pytest
import torch

from repro_torch.obs import Tracer
from repro_torch.obs.summarize import summarize


def _opened_together(device, n):
    """[(span start, span end, range start, range end)] in ns for `n`
    spans, each with a range of its name opened inside it around a
    little work on `device`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    tr = Tracer(enabled=True)
    x = torch.ones(1024, device=device)
    with profile(activities=acts) as prof:
        with record_function("clock.warm"):     # a first range's set-up
            x.sum().item()
        for i in range(n):
            with tr.span(f"clock.pair{i}"), record_function(f"clock.pair{i}"):
                x.sum().item()
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock.pair")
              and e.device_type() == torch.autograd.DeviceType.CPU}
    spans = tr.spans()
    assert len(spans) == len(ranges) == n
    return tr, [(s["t0_ns"], s["t0_ns"] + s["dur_ns"], *ranges[s["name"]])
                for s in spans]


def _check(pairs, tol_ns):
    """Each range inside its span, give or take `tol_ns`, and the
    starts `tol_ns` apart at the median; returns (median, widest) start
    gap in µs."""
    for s0, s1, r0, r1 in pairs:
        assert s0 - tol_ns <= r0 and r1 <= s1 + tol_ns, (s0, s1, r0, r1)
    gaps = [abs(r0 - s0) for s0, _, r0, _ in pairs]
    assert statistics.median(gaps) < tol_ns, gaps
    return statistics.median(gaps) / 1e3, max(gaps) / 1e3


def test_a_span_and_a_profiler_range_start_together():
    tr, pairs = _opened_together(torch.device("cpu"), 5)
    _check(pairs, 1_000_000)
    events = tr.chrome_events()
    assert [e["ts"] * 1e3 for e in events] == pytest.approx(
        [s0 for s0, *_ in pairs], abs=1e3)
    assert summarize({"traceEvents": events})["events"] == len(pairs)


@pytest.mark.cuda
def test_a_span_and_a_profiler_range_start_together_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, pairs = _opened_together(torch.device("cuda"), 20)
    median, widest = _check(pairs, 100_000)
    print(f"range start - span start: median {median:.2f} us, widest "
          f"{widest:.2f} us over {len(pairs)} pairs, each range inside "
          f"its span")
