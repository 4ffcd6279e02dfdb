"""Port parity, tensor-parallel serving at W = 2 (data 1 × model 2) on
the CPU: every LM family's smoke config in float32 (`tests/tp_cases.py`),
prefill logits and 4 greedy decode steps' logits of the port's sharded
steps (two spawned gloo ranks) within 1e-4 of the reference's sharded
`make_prefill` / `make_decode` on the same mesh (`tests/ref_tp.py`,
4 forced host devices) and of the port's one-device steps; greedy
tokens equal, and equal on every rank.  Each case splits some leaf.
W = 4 is in tests/test_torch_tp_serving4.py.
"""
import pytest
import torch
import tp_cases as C
from torch_ranks import join_ranks, start_ranks

torch.set_num_threads(1)

MESHES = [[1, 2]]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp2"))
    C.write_inputs(d)
    ref = C.start_reference(d, MESHES)
    ranks = start_ranks(C.rank_main, 2, d, d, [2])
    with torch.inference_mode():
        want = {a: C.serve(C.cfg_of(a), *C.load(d, a)) for a in C.ARCHS}
    join_ranks(ranks)
    C.finish_reference(ref)
    return d, want


@pytest.mark.parametrize("arch", C.ARCHS)
def test_tp_serving_matches_reference_at_model_2(served, arch):
    d, want = served
    C.check(d, arch, (1, 2), want[arch])
