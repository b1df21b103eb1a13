"""NMS + extraction vs the literal fastExtract branch-logic oracle.

This validates the derived uniform per-pixel NMS rule against the reference's
actual 2x2-branch control flow (Fast.h:258-310), including bucketing.
"""

import numpy as np
import pytest

import oracles
from pislam_tpu.ops import nms

BORDER = 16


def scored_map(h, w, seed, density=0.05):
    """Synthetic scored mask with the frontend's real structure."""
    rng = np.random.default_rng(seed)
    m = np.zeros((h, w), np.uint8)
    hits = rng.random((h, w)) < density
    m[hits] = rng.integers(1, 256, hits.sum())
    m[:BORDER] = m[-BORDER:] = 0
    m[:, :BORDER] = m[:, -BORDER:] = 0
    return m


def run_pair(score, k=1024, log_bucket_size=0, bucket_limit=5):
    h, w = score.shape
    valid = np.zeros((h, w), bool)
    valid[BORDER:h - BORDER, BORDER:w - BORDER] = True
    codes, valid_out = nms.extract(
        score, valid, k, border=BORDER,
        log_bucket_size=log_bucket_size, bucket_limit=bucket_limit,
    )
    got = set(np.asarray(codes)[np.asarray(valid_out)].tolist())
    want = set(
        oracles.fast_extract(score, BORDER, log_bucket_size, bucket_limit)
    )
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_extract_matches_reference_branches(seed):
    score = scored_map(64, 96, seed)
    got, want = run_pair(score)
    assert got == want


def test_extract_dense_scores():
    # high density stresses the tie-breaking chains
    score = scored_map(64, 64, 42, density=0.5)
    got, want = run_pair(score)
    assert got == want


def test_extract_with_ties():
    # constant-score plateaus: tie-breaking must pick the raster-first pixel
    score = np.zeros((48, 48), np.uint8)
    score[20:24, 20:24] = 7  # plateau
    score[30, 30] = 9
    score[30, 31] = 9  # horizontal tie
    score[33, 30] = 4
    score[34, 30] = 4  # vertical tie
    got, want = run_pair(score)
    assert got == want


@pytest.mark.parametrize("log_bucket_size,bucket_limit", [(4, 5), (3, 2), (5, 1)])
def test_bucketing(log_bucket_size, bucket_limit):
    score = scored_map(96, 96, 5, density=0.3)
    got, want = run_pair(score, k=2048, log_bucket_size=log_bucket_size,
                         bucket_limit=bucket_limit)
    assert got == set(want)


@pytest.mark.parametrize("log_bucket_size,bucket_limit",
                         [(4, 5), (3, 2), (5, 1), (1, 1), (2, 3)])
def test_bucketing_on_reduced_grid(log_bucket_size, bucket_limit):
    """Bucketing commutes with an exact 2x2 pre-reduction of the code grid
    (a candidate for cutting top-K's input 4x): 3x3 NMS leaves at most one
    survivor per 2x2 block, and with an even border each block lies whole
    inside one bucket cell, so the halved-geometry bucket_topk keeps
    exactly the same code set as the full-grid one."""
    import jax.numpy as jnp

    score = scored_map(96, 128, 11, density=0.4)
    keep = nms.nms(jnp.asarray(score))
    enc = nms.encode_grid(jnp.asarray(score), keep)
    full = nms.bucket_topk(enc, BORDER, log_bucket_size, bucket_limit)

    # 2x2 block max of the code grid
    red = jnp.maximum(enc[0::2], enc[1::2])
    red = jnp.maximum(red[:, 0::2], red[:, 1::2])
    if bucket_limit < (1 << (log_bucket_size - 1)) ** 2:
        red = nms.bucket_topk(red, BORDER // 2, log_bucket_size - 1,
                              bucket_limit)

    want = set(np.asarray(full)[np.asarray(full) != 0].tolist())
    got = set(np.asarray(red)[np.asarray(red) != 0].tolist())
    assert got == want


def test_topk_truncation_keeps_strongest():
    score = scored_map(64, 96, 9, density=0.3)
    got_all, want = run_pair(score, k=4096)
    k = max(len(want) // 2, 1)
    codes, valid = nms.extract(
        score,
        np.pad(np.ones((64 - 2 * BORDER, 96 - 2 * BORDER), bool),
               ((BORDER, BORDER), (BORDER, BORDER))),
        k, border=BORDER,
    )
    got_k = np.asarray(codes)[np.asarray(valid)]
    assert len(got_k) == k
    assert set(got_k.tolist()) == set(sorted(want, reverse=True)[:k])
