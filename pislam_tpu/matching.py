"""Brute-force Hamming descriptor matching as one int8 matmul.

The reference delegates matching to external FLANN with LUT popcounts
(<20 ms/frame on Pi3, README.md:125-128, "room for improvement") and ships
nothing. Here: expand each 256-bit descriptor to a +/-1 int8
vector; then

    dot(a, b) = 256 - 2 * hamming(a, b)   =>   hamming = (256 - dot) >> 1

so the full K1 x K2 distance matrix is ONE int8 matmul (exact int32
accumulation), followed by vectorised best/second-best reduction, Lowe ratio
test, distance threshold, and mutual cross-check -- all fixed-shape.

Invalid slots (validity mask false) get distance MAX_DIST and can never match.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

MAX_DIST = 1 << 14  # sentinel > any real Hamming distance (<= 256)


def expand_pm1(desc):
    """(K, words) uint32 packed bits -> (K, words*32) int8 in {-1, +1}."""
    k, words = desc.shape
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(k, words * 32)
    return (2 * bits.astype(jnp.int32) - 1).astype(jnp.int8)


def hamming_matrix(desc1, desc2, valid1=None, valid2=None):
    """(K1, w), (K2, w) packed descriptors -> (K1, K2) int32 Hamming distances.

    Exact: int8 dot with int32 accumulation.
    """
    nbits = desc1.shape[1] * 32
    a = expand_pm1(desc1)
    b = expand_pm1(desc2)
    dot = jax.lax.dot_general(
        a, b, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    dist = (nbits - dot) >> 1
    if valid1 is not None:
        dist = jnp.where(valid1[:, None], dist, MAX_DIST)
    if valid2 is not None:
        dist = jnp.where(valid2[None, :], dist, MAX_DIST)
    return dist


def gate(dist, uv1, uv2, radius: float):
    """Pin pairs farther apart than `radius` on the normalised plane to
    MAX_DIST (pairs exactly on the radius stay candidates)."""
    d2 = jnp.sum((uv1[:, None, :] - uv2[None, :, :]) ** 2, axis=-1)
    return jnp.where(d2 <= radius * radius, dist, MAX_DIST)


def _best_two(dist):
    """Row-wise (best_idx, best, second_best) of a distance matrix.

    Scatter-free: the second best is a masked second min."""
    best_idx = jnp.argmin(dist, axis=1)
    best = jnp.min(dist, axis=1)
    cols = jnp.arange(dist.shape[1], dtype=best_idx.dtype)
    masked = jnp.where(cols[None, :] == best_idx[:, None], MAX_DIST, dist)
    second = jnp.min(masked, axis=1)
    return best_idx, best, second


def _accept(dist, valid1, max_distance, ratio, cross_check):
    """Best match per row through threshold, Lowe ratio and cross-check.

    Returns (idx2 (K1,) int32 with -1 for unmatched, dist (K1,) int32)."""
    idx2, best, second = _best_two(dist)
    ok = best <= max_distance
    ok &= best.astype(jnp.float32) < ratio * second.astype(jnp.float32)
    if cross_check:
        rbest_idx = jnp.argmin(dist, axis=0)
        ok &= rbest_idx[idx2] == jnp.arange(dist.shape[0])
    ok &= valid1
    return jnp.where(ok, idx2, -1), jnp.where(ok, best, MAX_DIST)


@partial(jax.jit, static_argnames=("max_distance", "cross_check"))
def match(desc1, desc2, valid1, valid2, max_distance: int = 64,
          ratio: float = 0.8, cross_check: bool = True):
    """Match descriptors frame1 -> frame2.

    Returns (idx2 (K1,) int32 with -1 for unmatched, dist (K1,) int32).
    Filters: Hamming <= max_distance, Lowe ratio best < ratio*second,
    and optional mutual-best cross-check.
    """
    dist = hamming_matrix(desc1, desc2, valid1, valid2)
    return _accept(dist, valid1, max_distance, ratio, cross_check)


@partial(jax.jit, static_argnames=("radius", "max_distance", "cross_check"))
def match_gated(desc1, desc2, valid1, valid2, uv1, uv2, radius: float,
                max_distance: int = 64, ratio: float = 0.8,
                cross_check: bool = True):
    """Projection-gated matching: only pairs within `radius` of each other
    on the normalised image plane are candidates.

    The ORB-SLAM local-map idiom (the reference never shipped matching at
    all, README.md:125-128): landmarks are projected with a pose prior and
    each feature matches only against landmarks landing nearby. Beyond the
    search-space cut this changes the STATISTICS of the ratio test -- the
    second-best is the second-best WITHIN the gate, so far-away landmarks
    with similar (aliased) descriptors no longer kill correct matches.

    uv1 (K1, 2), uv2 (K2, 2): normalised-plane coordinates of the query
    features and the projected landmarks (pass inf/large values for
    behind-camera projections to exclude them).
    """
    dist = gate(hamming_matrix(desc1, desc2, valid1, valid2), uv1, uv2,
                radius)
    return _accept(dist, valid1, max_distance, ratio, cross_check)


@partial(jax.jit, static_argnames=("max_distance", "cross_check"))
def match_many(descs, valids, desc2, valid2, max_distance: int = 64,
               ratio: float = 0.8, cross_check: bool = True):
    """Match a whole keyframe store against one query frame in ONE dispatch.

    descs (F, K1, words), valids (F, K1): the stored keyframes' descriptor
    blocks; desc2/valid2 (K2, words)/(K2,): the query. Returns
    (idx2 (F, K1) int32 with -1 unmatched, counts (F,) int32) with identical
    per-keyframe semantics to `match` (threshold + ratio + cross-check).

    This is the batched loop-closure/relocalisation primitive: the round-1
    implementation issued one jitted dispatch + one ~30 ms host readback per
    stored keyframe (ADVICE round-1); here the (F*K1, K2) distance matrix is
    one int8 matmul and the host reads back a single (F,) count vector.
    """
    f, k1, words = descs.shape
    nbits = words * 32
    a = expand_pm1(descs.reshape(f * k1, words))
    b = expand_pm1(desc2)
    dot = jax.lax.dot_general(
        a, b, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)
    dist = ((nbits - dot) >> 1).reshape(f, k1, -1)
    dist = jnp.where(valids[:, :, None], dist, MAX_DIST)
    dist = jnp.where(valid2[None, None, :], dist, MAX_DIST)

    best_idx = jnp.argmin(dist, axis=2)
    best = jnp.min(dist, axis=2)
    cols = jnp.arange(dist.shape[2], dtype=best_idx.dtype)
    masked = jnp.where(cols[None, None, :] == best_idx[:, :, None],
                       MAX_DIST, dist)
    second = jnp.min(masked, axis=2)
    ok = best <= max_distance
    ok &= best.astype(jnp.float32) < ratio * second.astype(jnp.float32)
    if cross_check:
        col_best = jnp.argmin(dist, axis=1)  # (F, K2)
        ok &= jnp.take_along_axis(col_best, best_idx, axis=1) \
            == jnp.arange(k1)[None, :]
    ok &= valids
    idx2 = jnp.where(ok, best_idx, -1)
    counts = jnp.sum(ok.astype(jnp.int32), axis=1)
    return idx2, counts


def match_features(f1, f2, cfg):
    """Convenience wrapper over Features pairs (frontend.Features)."""
    return match(
        f1.descriptors, f2.descriptors, f1.valid, f2.valid,
        max_distance=cfg.matcher.max_distance, ratio=cfg.matcher.ratio,
        cross_check=cfg.matcher.cross_check,
    )
