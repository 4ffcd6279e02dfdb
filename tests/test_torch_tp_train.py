"""Port parity, sharded training at W = 2 (data 1 × model 2) on the
CPU: every LM family's smoke config in float32 (`tests/tp_train_cases.py`).

 * Gradients: the first step's gradient of every leaf, gathered whole
   from the two spawned gloo ranks, within 1e-5 · max(1, max |g|) of the
   port's one-device gradient, and the sharded global norm within 1e-5
   relative of one device's (all seven families).
 * Steps: 3 AdamW steps (lr 3e-4, 5 warm-up steps) against the
   reference's sharded `make_train_step` on the same mesh
   (`tests/ref_tp_train.py`, 4 forced host devices): losses within
   1e-5, params within 2e-5 (the reference's own meshes agree within
   6.4e-6 of its unsharded run; the rest is the two packages' summation
   orders).  qwen3, granite-34b, granite-moe and mamba2 here; every
   family at data 2 × model 2 in tests/test_torch_tp_train4.py.

Each case holds some leaf split over the model axis.
"""
import pytest
import torch
import tp_train_cases as C
from torch_ranks import join_ranks, start_ranks

torch.set_num_threads(1)

MESH = (1, 2)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tptrain2"))
    C.write_inputs(d)
    ref = C.start_reference(d, [[(a, MESH) for a in C.EVERY_MESH]])
    ranks = start_ranks(C.rank_main, 2, d, d, [(2, C.ARCHS)],
                        timeout=C.DEADLINE_S)
    want = {a: C.one_device(d, a) for a in C.ARCHS}
    join_ranks(ranks)
    C.finish_reference(ref)
    return d, want


@pytest.mark.parametrize("arch", C.ARCHS)
def test_sharded_gradients_match_one_device_at_model_2(trained, arch):
    d, want = trained
    C.check_grads(d, arch, MESH, want[arch])


@pytest.mark.parametrize("arch", C.EVERY_MESH)
def test_sharded_steps_match_reference_at_model_2(trained, arch):
    d, _ = trained
    C.check_steps(d, arch, MESH)
