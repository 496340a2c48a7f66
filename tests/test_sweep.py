"""Checkpoint/resume for Monte-Carlo sweeps (SURVEY.md §5.4): an interrupted
sweep must resume from the scenario cursor and reproduce an uninterrupted run
bitwise."""

import os

import numpy as np

from mpctsid_tpu.sweep import (METRIC_KEYS, SweepState, run_sweep,
                               scenario_params, summarize)

TOTAL = 12
CHUNK = 4
PERIODS = 2
SEED = 7


def test_scenario_params_chunk_invariant():
    """Per-scenario draws depend only on (seed, index), never on chunking."""
    g_all, v_all, m_all, p_all = scenario_params(SEED, np.arange(TOTAL))
    g_a, v_a, m_a, p_a = scenario_params(SEED, np.arange(0, 5))
    g_b, v_b, m_b, p_b = scenario_params(SEED, np.arange(5, TOTAL))
    np.testing.assert_array_equal(np.concatenate([g_a, g_b]), g_all)
    np.testing.assert_array_equal(np.concatenate([v_a, v_b]), v_all)
    np.testing.assert_array_equal(np.concatenate([m_a, m_b]), m_all)
    np.testing.assert_array_equal(np.concatenate([p_a, p_b]), p_all)
    # payload spread actually spans the draw range (BASELINE.json:9 "load")
    assert p_all.min() >= 0.0 and p_all.max() <= 0.4 and p_all.std() > 0.05


def test_interrupt_resume_bitwise(tmp_path):
    ckpt = str(tmp_path / "sweep.npz")

    # uninterrupted reference
    ref = run_sweep(SweepState.fresh(SEED, TOTAL, PERIODS), CHUNK,
                    verbose=False)
    assert ref.cursor == TOTAL

    # interrupted after 1 chunk, checkpointed, then resumed from disk
    st = SweepState.fresh(SEED, TOTAL, PERIODS)
    st = run_sweep(st, CHUNK, ckpt_path=ckpt, max_chunks=1, verbose=False)
    assert st.cursor == CHUNK
    assert os.path.exists(ckpt)
    del st

    resumed = SweepState.load(ckpt)
    assert resumed.cursor == CHUNK
    assert np.isnan(resumed.metrics["final_z"][CHUNK:]).all()
    resumed = run_sweep(resumed, CHUNK, ckpt_path=ckpt, verbose=False)
    assert resumed.cursor == TOTAL

    for k in METRIC_KEYS:
        np.testing.assert_array_equal(resumed.metrics[k], ref.metrics[k],
                                      err_msg=k)

    s = summarize(resumed)
    assert s["scenarios"] == TOTAL
    assert 0.0 <= s["upright_frac"] <= 1.0


def test_checkpoint_npz_roundtrip():
    """A checkpoint restores every field, the unfinished NaN tail included,
    as writable arrays."""
    st = SweepState.fresh(SEED, TOTAL, PERIODS)
    st.cursor = 5
    for i, k in enumerate(METRIC_KEYS):
        st.metrics[k][:5] = np.arange(5) + i
    back = SweepState.from_bytes(st.to_bytes())
    assert (back.seed, back.total, back.cursor, back.n_periods) == \
        (SEED, TOTAL, 5, PERIODS)
    assert sorted(back.metrics) == sorted(METRIC_KEYS)
    for k in METRIC_KEYS:
        np.testing.assert_array_equal(back.metrics[k], st.metrics[k])
        assert back.metrics[k].dtype == np.float32
    back.metrics["upright"][5] = 1.0       # resume writes into the arrays


def test_tail_padding(tmp_path):
    """total not divisible by chunk: the padded tail must not leak into the
    stored metrics."""
    st = run_sweep(SweepState.fresh(SEED, 6, PERIODS), 4, verbose=False)
    assert st.cursor == 6
    assert not np.isnan(st.metrics["final_z"]).any()
    ref = run_sweep(SweepState.fresh(SEED, 6, PERIODS), 6, verbose=False)
    for k in METRIC_KEYS:
        np.testing.assert_array_equal(st.metrics[k], ref.metrics[k],
                                      err_msg=k)
