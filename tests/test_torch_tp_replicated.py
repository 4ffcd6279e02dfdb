"""Port parity, the 'dp_replicated' layout on the CPU: whisper-base's
smoke config (4 heads) at a model axis of 3 on W = 3 spawned gloo
ranks, where `pick_layout` gives 'dp_replicated' as the reference's
does (the state fits, 3 does not divide 4 heads).  Every rank holds
every leaf whole and its 2 rows of a batch of 6 (split over every
axis); no collective runs over the model axis inside a layer, K4's
route takes every head, and the gradients of the ranks' rows are
summed over all three (`tests/tp_layout_cases.py`).

 * Serving: prefill logits and 4 greedy decode steps within 1e-4 of the
   reference's sharded `make_prefill` / `make_decode` on a 1 × 3 mesh
   and of the port's one device, tokens equal on every rank; an
   `LMSession` of 6 rows that evicts slot 1 and admits a sequence (its
   K/V rows written by rank 0, which holds rows 0–1) takes one device's
   tokens in every slot.
 * Training: the first step's gradient gathered whole and each rank's
   own copy of it within 1e-5 · max(1, max |g|) of one device's, the
   global norm within 1e-5, and 2 AdamW steps within 1e-5 (loss) / 2e-5
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

ARCH = "whisper-base"
AGAINST = ["reference", "one-device"]


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tprep"))
    L.write_inputs(d, ARCH)
    ref = L.start_reference(d, ARCH)
    ranks = start_ranks(L.rank_main, L.CASES[ARCH][0], d, d, ARCH)
    want = L.one_device(d, ARCH)
    join_ranks(ranks)
    L.finish_reference(ref)
    return d, want


def test_whisper_takes_dp_replicated_at_model_3(ran):
    d, _ = ran
    got = L.port(d, ARCH)
    assert str(got["layout"]) == "dp_replicated"
    assert int(got["split"]) == 0          # every leaf whole on every rank


@pytest.mark.parametrize("against", AGAINST)
def test_dp_replicated_serving_matches(ran, against):
    d, want = ran
    L.check_served(d, ARCH, want, against)


def test_dp_replicated_session_admits_into_the_rank_that_holds_the_slot(ran):
    d, want = ran
    L.check_session(d, ARCH, want)


def test_dp_replicated_gradients_match_one_device(ran):
    d, want = ran
    L.check_grads(d, ARCH, want)


def test_dp_replicated_ranks_hold_whole_gradients(ran):
    d, want = ran
    whole, split = L.check_rank_blocks(d, ARCH, want)
    assert not split and whole


def test_dp_replicated_checkpoint_restores_on_one_device(ran):
    d, _ = ran
    L.check_checkpoint(d, ARCH)


@pytest.mark.parametrize("against", AGAINST)
def test_dp_replicated_steps_match(ran, against):
    d, want = ran
    L.check_steps(d, ARCH, want, against)
