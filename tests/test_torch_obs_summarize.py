"""`python -m repro_torch.obs summarize` over a trace the port's tracer
wrote: the summary equals the reference's `repro.obs.summarize` on the
same document, and the CLI's exit codes are the reference's."""
import json

import pytest

from repro_torch.obs import get_tracer, set_tracer
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.obs.summarize import summarize


@pytest.fixture(scope="module")
def trace_doc(tmp_path_factory):
    """A trace of one `launch.mine` count on the CPU (`--trace`)."""
    from repro_torch.launch import mine

    path = tmp_path_factory.mktemp("trace") / "trace.json"
    before = get_tracer()
    try:
        assert mine.main(["--device", "cpu", "--pattern", "P1",
                          "--dataset", "tiny-er", "--trace",
                          str(path)]) == 0
    finally:
        set_tracer(before)
    return path, json.loads(path.read_text())


def test_summary_equals_the_reference(trace_doc):
    from repro.obs.summarize import summarize as ref_summarize

    _, doc = trace_doc
    got = summarize(doc)
    assert got == ref_summarize(doc)
    names = {r["name"] for r in got["rows"]}
    assert {"engine.round", "engine.execute"} <= names
    assert got["events"] == len([e for e in doc["traceEvents"]
                                 if e.get("ph") == "X"])


def test_cli_summarizes_and_gates(trace_doc, tmp_path, capsys):
    """`--top 5` prints exactly the five rows `summarize` ranks first for
    the same document (ranked by measured self-time, so which spans they
    are varies with the load of the run that wrote the trace)."""
    path, doc = trace_doc
    assert obs_main(["summarize", str(path), "--top", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = summarize(doc)["rows"]
    at = next(i for i, ln in enumerate(out) if ln.split()[:1] == ["span"])
    printed = [ln.split()[0].rstrip("*") for ln in out[at + 1:at + 6]]
    assert len(rows) > 5
    assert printed == [r["name"] for r in rows[:5]]
    assert out[at + 6].strip() == f"... {len(rows) - 5} more span names"
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": []}))
    assert obs_main(["summarize", str(bad)]) != 0
    assert obs_main(["summarize", str(tmp_path / "missing.json")]) != 0
    assert obs_main(["bogus"]) == 1
    assert obs_main([]) == 1
