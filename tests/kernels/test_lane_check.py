"""The lane checks chip_smoke.py runs on the card (evals/lane_check.py),
here at small widths on the CPU: every lane of the production packed
program against its numpy reference, for each dense storage dtype and
both dense modes, plus device RRF against the host oracle."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

from cadence_rag_tpu.evals import lane_check as lc

N_CALLS = 16
CHUNK_KS = (10, 10, 10)
ARTIFACT_KS = (5, 5, 10)
ROWS = list(range(8))
FILTERED = [4, 5, 6, 7]


def _corpus(rng, n, cap, *, dim=64, lex_dim=256, slots=8, emb_dtype="bf16",
            days=4, tech_hi=40):
    """Synthetic corpus arrays at capacity ``cap`` (rows >= n are padding).
    Tech tokens come from a small range so matches are many, and
    call-start seconds from a few days so ties are the rule."""
    emb = rng.standard_normal((cap, dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    if emb_dtype == "int8":
        emb = np.clip(np.round(emb * 127.0), -127, 127).astype(np.int8)
    elif emb_dtype == "bf16":
        emb = emb.astype(ml_dtypes.bfloat16)
    started = (1_600_000_000 + 86400 * rng.integers(0, days, cap)).astype(
        np.int32
    )
    started[n:] = lc.INT32_MIN
    has_emb = np.arange(cap) < n
    has_emb[rng.choice(n, size=n // 50, replace=False)] = False
    return lc.HostCorpus(
        emb=emb,
        lex=rng.integers(-4, 5, (cap, lex_dim)).astype(np.int8),
        tech=rng.integers(1, tech_hi, (cap, slots)).astype(np.int32),
        call_idx=rng.integers(0, N_CALLS, cap).astype(np.int32),
        started=started,
        has_emb=has_emb,
    )


def _device(corpus):
    return tuple(jnp.asarray(a) for a in (
        corpus.emb, corpus.lex, corpus.tech, corpus.call_idx,
        corpus.started, corpus.has_emb,
    ))


def _setup(emb_dtype, seed=0, days=4, tech_hi=40):
    rng = np.random.default_rng(seed)
    chunks = _corpus(rng, 1800, 2048, emb_dtype=emb_dtype, days=days,
                     tech_hi=tech_hi)
    artifacts = _corpus(rng, 400, 512, emb_dtype=emb_dtype, days=days,
                        tech_hi=tech_hi)
    qb = lc.make_queries(chunks, batch=16, n_calls=N_CALLS, q_feats=32,
                         tech_capacity=1, filtered_rows=FILTERED, seed=seed)
    return chunks, artifacts, qb


_RESULTS = {}


def _results(emb_dtype, mode):
    key = (emb_dtype, mode)
    if key not in _RESULTS:
        chunks, artifacts, qb = _setup(emb_dtype)
        _RESULTS[key] = lc.check_lanes(
            _device(chunks), _device(artifacts), chunks, artifacts, qb,
            ROWS, chunk_ks=CHUNK_KS, artifact_ks=ARTIFACT_KS, mode=mode,
        )
    return _RESULTS[key]


@pytest.mark.parametrize("mode", ["exact", "ann"])
@pytest.mark.parametrize("emb_dtype", ["bf16", "int8", "float32"])
def test_dense_lane_matches_reference(emb_dtype, mode):
    res = _results(emb_dtype, mode)
    for corpus in ("chunks", "artifacts"):
        # the CPU backend's approx_max_k is an exact sort: ann == exact
        assert res[f"{corpus}.dense"]["min"] == 1.0, res[f"{corpus}.dense"]
    assert not lc.failures(res), lc.failures(res)


def test_lexical_lane_matches_reference():
    for mode in ("exact", "ann"):
        res = _results("bf16", mode)
        for corpus in ("chunks", "artifacts"):
            assert res[f"{corpus}.lex"]["min"] == 1.0, res[f"{corpus}.lex"]


def test_tech_lane_ids_and_order_match_reference():
    res = _results("bf16", "ann")
    for corpus in ("chunks", "artifacts"):
        tech = res[f"{corpus}.tech"]
        assert tech["identical"], tech
        assert tech["matches"] > 0


def test_device_rrf_matches_host_oracle():
    for mode in ("exact", "ann"):
        res = _results("bf16", mode)["rrf"]
        assert res["identical"], res
        assert res["rows"] == 16


def test_tech_lane_keeps_id_order_under_equal_started_sec_on_ann_path():
    """Every row of every call shares one started_sec (days=1): the tech
    lane's order is then position (= id) ascending alone, and the ann
    dense mode must not change it."""
    chunks, artifacts, qb = _setup("bf16", seed=3, days=1, tech_hi=10)
    flat = lc.run_packed(_device(chunks), _device(artifacts), qb,
                         chunk_ks=CHUNK_KS, artifact_ks=ARTIFACT_KS,
                         mode="ann", fuse_rrf=False)
    lanes, _ = lc.split_lanes(flat, chunk_ks=CHUNK_KS,
                              artifact_ks=ARTIFACT_KS, mode="ann")
    scores, pos = lanes["tech"]
    ref = lc.tech_reference(chunks, qb, ROWS, CHUNK_KS[2])
    for i, b in enumerate(ROWS):
        got = pos[b][np.isfinite(scores[b])]
        assert got.size == CHUNK_KS[2]          # ties fill the lane
        assert np.all(np.diff(got) > 0), got    # id ASC
        np.testing.assert_array_equal(got, ref[i])


def test_failures_names_each_lane_below_target():
    res = {
        "chunks.dense": {"mean": 0.5, "min": 0.5, "rows": 1},
        # one bad row in 16 fails the lane although the mean passes
        "chunks.lex": {"mean": 0.99, "min": 0.84, "rows": 16},
        "artifacts.lex": {"mean": 1.0, "min": 1.0, "rows": 16},
        "chunks.tech": {"identical": False, "mismatched_rows": [3],
                        "rows": 1, "matches": 1},
        "rrf": {"identical": True, "mismatched": [], "rows": 1},
    }
    bad = lc.failures(res)
    assert len(bad) == 3
    assert bad[0].startswith("chunks.dense")
    assert bad[1].startswith("chunks.lex") and "0.8400" in bad[1]
    assert "[3]" in bad[2]
