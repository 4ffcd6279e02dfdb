"""Port parity, 'tp2d' with attention heads the model axis does not
divide, on the CPU: minitron-4b's smoke config (6 query heads over 2 KV
heads, d_model 96) at a model axis of 4 on W = 4 spawned gloo ranks,
the layout forced to 'tp2d' on both sides (`pick_layout` gives it
'dp_replicated', since the smoke config fits; the full config at a
model axis of 16 takes this path).  wq / wk / wv / wo are whole on
every model rank and every rank computes all 6 heads on the same
input, with no all_reduce after wo; the MLP and the vocabulary are
split over the model axis; the decode cache splits its sequence
(2 KV heads over 4: flash-decoding with every query head on every
rank) (`tests/tp_layout_cases.py`).

 * Serving: prefill logits and 4 greedy decode steps within 1e-4 of the
   reference's sharded `make_prefill` / `make_decode` on a 1 × 4 mesh
   and of the port's one device, tokens equal on every rank.
 * Training: the first step's gradient gathered whole within 1e-5 ·
   max(1, max |g|) of one device's and the global norm within 1e-5;
   each rank's own gradient of wq / wo (whole: the data axis has one
   rank, so no ZeRO-3 block) and of its vocabulary block of the
   embedding equals the one-device gradient's part, not M times it
   (the attention's input skips `tp.copy_in`, whose backward would sum
   it over the model axis); 2 AdamW steps within 1e-5 (loss) / 2e-5
   (params) of the reference's sharded `make_train_step` and of one
   device.
 * Checkpoints: one device's checkpoint restores into every rank's
   pieces, and the ranks' checkpoint after the steps (whole leaves,
   written by rank 0) restores into them and on one device.
"""
import pytest
import torch
import tp_layout_cases as L
from torch_ranks import join_ranks, start_ranks

torch.set_num_threads(1)

ARCH = "minitron-4b"
AGAINST = ["reference", "one-device"]


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpwhole"))
    L.write_inputs(d, ARCH)
    ref = L.start_reference(d, ARCH)
    ranks = start_ranks(L.rank_main, L.CASES[ARCH][0], d, d, ARCH)
    want = L.one_device(d, ARCH)
    join_ranks(ranks)
    L.finish_reference(ref)
    return d, want


def test_minitron_forced_tp2d_splits_the_mlp(ran):
    d, _ = ran
    got = L.port(d, ARCH)
    assert str(got["layout"]) == "tp2d"
    assert int(got["split"]) > 0


@pytest.mark.parametrize("against", AGAINST)
def test_whole_heads_serving_matches(ran, against):
    d, want = ran
    L.check_served(d, ARCH, want, against)


def test_whole_heads_gradients_match_one_device(ran):
    d, want = ran
    L.check_grads(d, ARCH, want)


def test_whole_heads_rank_gradients_are_not_summed_over_the_model_axis(ran):
    d, want = ran
    whole, split = L.check_rank_blocks(d, ARCH, want)
    for i in range(2):
        for w in ("wq", "wk", "wv", "wo"):
            assert f"layers/{i}/attn/{w}/w" in whole
        assert f"layers/{i}/mlp/gate/w" in split
    assert "embed/w" in split


def test_whole_heads_checkpoint_restores_on_one_device(ran):
    d, _ = ran
    L.check_checkpoint(d, ARCH)


@pytest.mark.parametrize("against", AGAINST)
def test_whole_heads_steps_match(ran, against):
    d, want = ran
    L.check_steps(d, ARCH, want, against)
