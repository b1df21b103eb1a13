"""RANSAC essential-matrix estimation as a batched top-1 (SURVEY.md sec 7.4).

Data-dependent loop counts don't exist under XLA, so RANSAC becomes a
fixed-iteration vmap: sample `iters` 8-tuples at once, solve all essential
matrices in one batched SVD, score all hypotheses against all correspondences
with one (iters, N) Sampson evaluation, take the argmax, then refit on the
winner's inliers and recover the pose. Degenerate samples (duplicate indices
from masked categorical sampling) simply score poorly and lose.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import epipolar


@partial(jax.jit, static_argnames=("iters", "sample_size"))
def ransac_essential(key, p1, p2, valid, iters: int = 256,
                     sample_size: int = 8, inlier_threshold: float = 1.5e-3):
    """p1, p2: (N, 2) normalised correspondences; valid: (N,) bool.

    Returns dict with E (3,3), R (3,3), t (3,), inliers (N,) bool,
    num_inliers (), best hypothesis score.
    """
    n = p1.shape[0]
    logits = jnp.where(valid, 0.0, -jnp.inf)
    idx = jax.random.categorical(
        key, logits[None, :], shape=(iters, sample_size))  # (iters, 8)

    s1 = p1[idx]  # (iters, 8, 2)
    s2 = p2[idx]
    # SVD-free batched hypothesis solve (epipolar.essential_8pt_fast):
    # no per-hypothesis SVD over hundreds of tiny matrices. Scoring uses
    # the raw (unprojected) E; the winner below is refit with the exact SVD
    # path.
    es = epipolar.essential_8pt_fast(s1, s2)       # (iters, 3, 3)

    err = jax.vmap(lambda e: epipolar.sampson_error(e, p1, p2))(es)  # (iters, N)
    inl = (err < inlier_threshold) & valid[None, :]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)

    # refit on the winning inlier set (weighted 8-point over all N)
    w = inl[best].astype(p1.dtype)
    e_ref = epipolar.essential_8pt(p1, p2, weights=w)
    err_ref = epipolar.sampson_error(e_ref, p1, p2)
    inl_ref = (err_ref < inlier_threshold) & valid
    # keep whichever of (refit, best-sample) has more support
    better = jnp.sum(inl_ref) >= scores[best]
    e_fin = jnp.where(better, e_ref, es[best])
    inl_fin = jnp.where(better, inl_ref, inl[best])

    r, t, support = epipolar.recover_pose(e_fin, p1, p2, inl_fin.astype(p1.dtype))
    return {
        "E": e_fin,
        "R": r,
        "t": t,
        "inliers": inl_fin,
        "num_inliers": jnp.sum(inl_fin),
        "cheirality_support": support,
    }
