"""Port parity, sharded training at W = 4 on the CPU, as
tests/test_torch_tp_train.py does at W = 2: data 2 × model 2 (ZeRO-3:
every leaf the data axis divides is held in blocks and gathered where
its layer runs; the MoE keep decision taken over the whole batch) and
model 4 (the smoke configs' two KV heads then do not divide the axis,
so wk / wv stay whole and their gradient is summed over it), the
port's four spawned gloo ranks building both grids in one world.

 * Gradients: every leaf of the first step, gathered whole, within
   1e-5 · max(1, max |g|) of one device's, and the global norm within
   1e-5 relative, for all seven families on both grids.
 * Steps: 3 AdamW steps against the reference's sharded
   `make_train_step` on the same mesh (losses within 1e-5, params
   within 2e-5): every family at data 2 × model 2, and qwen3,
   granite-34b, granite-moe and mamba2 at model 4.
"""
import pytest
import torch
import tp_train_cases as C
from torch_ranks import join_ranks, start_ranks

torch.set_num_threads(1)

MESHES = [(2, 2), (1, 4)]
OTHERS = [a for a in C.ARCHS if a not in C.EVERY_MESH]
STEPPED = [(a, (2, 2)) for a in C.ARCHS] + [(a, (1, 4))
                                           for a in C.EVERY_MESH]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tptrain4"))
    C.write_inputs(d)
    ref = C.start_reference(d, [[(a, (2, 2)) for a in C.EVERY_MESH],
                                [(a, (2, 2)) for a in OTHERS],
                                [(a, (1, 4)) for a in C.EVERY_MESH]])
    ranks = start_ranks(C.rank_main, 4, d, d, [(2, C.ARCHS), (4, C.ARCHS)],
                        timeout=C.DEADLINE_S)
    want = {a: C.one_device(d, a) for a in C.ARCHS}
    join_ranks(ranks)
    C.finish_reference(ref)
    return d, want


@pytest.mark.parametrize("arch", C.ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=["data2-model2", "model4"])
def test_sharded_gradients_match_one_device_at_w4(trained, arch, mesh):
    d, want = trained
    C.check_grads(d, arch, mesh, want[arch])


@pytest.mark.parametrize("arch,mesh", STEPPED,
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m in STEPPED])
def test_sharded_steps_match_reference_at_w4(trained, arch, mesh):
    d, _ = trained
    C.check_steps(d, arch, mesh)
