"""The port's host-side eval helpers against the JAX package's: the result
TSV and the ``calculate`` metrics (eval/offline.py), the eval-set assembly
(data/dataset.py) and the phase timer (utils/timing.py)."""

import numpy as np
import pytest

from gdr_tpu.data.dataset import build_eval_data as jax_build_eval_data
from gdr_tpu.data.tokenize import HashTokenizer as JaxHashTokenizer
from gdr_tpu.eval import offline as joff
from gdr_tpu.utils.timing import PhaseTimer as JaxPhaseTimer
from gdr_tpu_torch.data.dataset import build_eval_data
from gdr_tpu_torch.data.tokenize import HashTokenizer
from gdr_tpu_torch.eval import offline as toff
from gdr_tpu_torch.utils.timing import PhaseTimer

# multi-row and multi-positive queries, a non-rank-1 row, an empty
# prediction list: the cases on which the two scoring modes differ
ROWS = [("q0", [3, 1, 4], [1], 1), ("q1", [5, 9, 2, 6], [9, 7], 1),
        ("q1", [5, 9, 2, 6], [7], 1), ("q2", [8, 3], [2], 2),
        ("q2", [2, 8], [2], 1), ("q3", [], [4], 1),
        ("q4", list(range(120)), [99, 101], 1)]


@pytest.fixture
def result_tsv(tmp_path):
    path = tmp_path / "res.tsv"
    joff.write_result_tsv(str(path), ROWS)
    return path


def test_write_result_tsv_is_byte_identical(result_tsv, tmp_path):
    ours = tmp_path / "port.tsv"
    toff.write_result_tsv(str(ours), ROWS)
    assert ours.read_bytes() == result_tsv.read_bytes()


def test_read_result_tsv_matches_jax(result_tsv):
    assert toff.read_result_tsv(str(result_tsv)) == \
        joff.read_result_tsv(str(result_tsv))


@pytest.mark.parametrize("ref_compat", [False, True],
                         ids=["default", "ref_compat"])
def test_calculate_matches_jax(result_tsv, ref_compat):
    got = toff.calculate(str(result_tsv), ref_compat=ref_compat)
    want = joff.calculate(str(result_tsv), ref_compat=ref_compat)
    assert got == want


def test_build_eval_data_matches_jax():
    queries = ["who wrote hamlet", "the speed of light", "x"]
    positives = [[0, 2], [1], [3, 0, 2]]
    cid_of_doc = ["1-2", "0-1", "1-2", "3-0-1"]
    got = build_eval_data(queries, positives, cid_of_doc,
                          HashTokenizer(vocab_size=512), 6)
    want = jax_build_eval_data(queries, positives, cid_of_doc,
                               JaxHashTokenizer(vocab_size=512), 6)
    np.testing.assert_array_equal(got.input_ids, want.input_ids)
    np.testing.assert_array_equal(got.attn_mask, want.attn_mask)
    assert got.gt_docs == want.gt_docs and got.gt_cids == want.gt_cids


def test_phase_timer_summary_keys_match_jax():
    got, want = PhaseTimer(), JaxPhaseTimer()
    for timer in (got, want):
        for name in ("retrieve", "decode_host", "retrieve"):
            with timer.phase(name):
                pass
    assert set(got.summary()) == set(want.summary())
    assert got.counts == want.counts == {"retrieve": 2, "decode_host": 1}
    s = got.summary()
    assert s["retrieve_mean_ms"] == pytest.approx(
        1e3 * s["retrieve_total_s"] / 2)
    got.reset()
    assert got.summary() == {}

