"""Port parity, tensor-parallel serving at W = 4 on the CPU: data 2 ×
model 2 (the batch split over data, the MoE keep decision taken over
the whole batch) and model 4 (the KV heads of every GQA smoke config
then do not divide the axis, so the decode cache splits its sequence:
flash-decoding), as tests/test_torch_tp_serving.py does at W = 2: the
port's four spawned gloo ranks build both grids in one world.  Then an
`LMSession` at data 2 × model 2 evicts a slot and admits a sequence
mid-decode (its K/V rows written by the data rank that holds them):
every slot's tokens equal one device's session's.
"""
import json

import pytest
import torch
import tp_cases as C
from torch_ranks import join_ranks, start_ranks

torch.set_num_threads(1)

MESHES = [[2, 2], [1, 4]]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp4"))
    C.write_inputs(d)
    ref = C.start_reference(d, MESHES)
    ranks = start_ranks(C.rank_main, 4, d, d, [2, 4])
    with torch.inference_mode():
        want = {a: C.serve(C.cfg_of(a), *C.load(d, a)) for a in C.ARCHS}
        want["sessions"] = {a: C.session_run(a) for a in C.SESSION_ARCHS}
    join_ranks(ranks)
    C.finish_reference(ref)
    return d, want


@pytest.mark.parametrize("arch", C.ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=["data2-model2", "model4"])
def test_tp_serving_matches_reference_at_w4(served, arch, mesh):
    d, want = served
    C.check(d, arch, tuple(mesh), want[arch])


@pytest.mark.parametrize("arch", C.SESSION_ARCHS)
def test_tp_session_admits_into_the_data_rank_that_holds_the_slot(
        served, arch):
    d, want = served
    with open(f"{d}/sessions.json") as f:
        got = json.load(f)[arch]
    one = json.loads(json.dumps(want["sessions"][arch]))
    assert got == one
    assert got["slot"] == 1 and len(got["slots"]["1"]) == 7
