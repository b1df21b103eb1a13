"""Non-max suppression and fixed-capacity keypoint selection.

Reference: fastExtract (Fast.h:196-355) scans the scored mask 2x2 at a time,
picks the strongest of the four center pixels via asymmetric >=/> chains, and
verifies it against the surrounding 4x4 word window (Fast.h:258-310).

We proved the branch structure decomposes into a uniform per-pixel rule
(each 2x2 branch's reachability conditions collapse to comparisons against
the in-cell neighbours; see the derivation notes below): a pixel survives iff

    s > 0
    and s >= each of {up-left, up, up-right, left}      (ties lose to the
    and s >  each of {right, down-left, down, down-right}  raster-earlier pixel)

i.e. standard 3x3 NMS with tie-breaking toward the top-left -- which affects
*which* keypoints survive and therefore matters for parity (SURVEY.md
section 7, hard part (a)). Derivation sketch: v0's branch uses > against
v1/v2/v3 (its right/down/down-right) and >=/> against the row0/row1/row2
boundary bytes in exactly this pattern (Fast.h:264-274); v1/v2/v3 are only
reachable when the earlier branches fail, and in each case failure plus the
branch's own strict tests implies >= against all raster-earlier neighbours
and > against all raster-later ones.

The reference's optional spatial bucketing (logBucketSize/bucketLimit,
Fast.h:316-341) keeps the top `bucketLimit` keypoints per bucketSize^2 cell
ordered by the packed uint32 encoding (score-major, then x, then y):
`bucket_topk` reproduces that with a per-cell top-k. Variable-length output
becomes a fixed-capacity top-K tensor + validity mask.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .fast import shift2d
from ..utils import codec


def nms(score):
    """(..., H, W) uint8 score map -> bool keep mask (exact reference rule)."""
    s = score

    def ge(dy, dx):
        return s >= shift2d(s, dy, dx)

    def gt(dy, dx):
        return s > shift2d(s, dy, dx)

    return (
        (s > 0)
        & ge(-1, -1) & ge(-1, 0) & ge(-1, 1) & ge(0, -1)
        & gt(0, 1) & gt(1, -1) & gt(1, 0) & gt(1, 1)
    )


def encode_grid(score, keep):
    """Packed uint32 keypoint code per pixel (0 where suppressed).

    The packing (score<<24 | x<<12 | y, Util.h:27) makes integer order =
    (score, x, y) lexicographic order, so top-k on the codes selects
    strongest-first with the reference's deterministic tie order.
    """
    h, w = score.shape[-2], score.shape[-1]
    ys = jnp.arange(h, dtype=jnp.uint32)[:, None]
    xs = jnp.arange(w, dtype=jnp.uint32)[None, :]
    enc = codec.encode(score.astype(jnp.uint32), xs, ys)
    return jnp.where(keep, enc, jnp.uint32(0))


def _u32_topk(codes_flat, k: int):
    """top-k of uint32 keys via order-preserving bijection to int32."""
    keys = jax.lax.bitcast_convert_type(
        codes_flat ^ jnp.uint32(0x80000000), jnp.int32
    )
    top, _ = jax.lax.top_k(keys, k)
    return jax.lax.bitcast_convert_type(top, jnp.uint32) ^ jnp.uint32(0x80000000)


def select_topk(enc_grid, k: int):
    """Global fixed-capacity selection: (H, W) codes -> ((k,) codes, (k,) valid).

    Equivalent to keeping every NMS survivor (demo path, logBucketSize=0,
    demo.cpp:89) when k >= #survivors; otherwise keeps the top-k by
    (score, x, y) -- the natural fixed-shape generalisation of the
    reference's unbounded std::vector append.
    """
    codes = _u32_topk(enc_grid.reshape(-1), k)
    return codes, codes != 0


def select_topk_scored(scored, k: int):
    """Fixed-capacity selection from a scored-survivor grid (u8, 0 = none)."""
    return select_topk(encode_grid(scored, scored > 0), k)


def bucket_topk(enc_grid, border: int, log_bucket_size: int, bucket_limit: int):
    """Per-cell cap: keep top `bucket_limit` codes per 2^log_bucket_size cell.

    Cells are anchored at (border, border) like the reference's bucket grid
    (bucket index (x-border)/bucketSize, flushed every bucketSize rows,
    Fast.h:210-227, 316-341). Returns the grid with losers zeroed.
    """
    bs = 1 << log_bucket_size
    h, w = enc_grid.shape[-2], enc_grid.shape[-1]
    # shift so cells align at (0,0), pad up to multiples of bs
    g = jnp.roll(enc_grid, (-border, -border), axis=(-2, -1))
    ph = -(-h // bs) * bs
    pw = -(-w // bs) * bs
    g = jnp.pad(g, ((0, ph - h), (0, pw - w)))
    cells = g.reshape(ph // bs, bs, pw // bs, bs).transpose(0, 2, 1, 3)
    cells = cells.reshape(ph // bs, pw // bs, bs * bs)
    keys = jax.lax.bitcast_convert_type(
        cells ^ jnp.uint32(0x80000000), jnp.int32
    )
    kth = jax.lax.top_k(keys, bucket_limit)[0][..., -1:]
    keep = keys >= kth
    cells = jnp.where(keep, cells, jnp.uint32(0))
    g = cells.reshape(ph // bs, pw // bs, bs, bs).transpose(0, 2, 1, 3)
    g = g.reshape(ph, pw)[:h, :w]
    return jnp.roll(g, (border, border), axis=(-2, -1))


@partial(jax.jit, static_argnames=("k", "log_bucket_size", "bucket_limit", "border"))
def extract(score, valid_mask, k: int, border: int = 16,
            log_bucket_size: int = 0, bucket_limit: int = 5):
    """Full extraction: NMS + (optional) bucketing + top-k.

    score: (H, W) uint8 scored mask (0 = not a candidate).
    valid_mask: (H, W) bool static region mask (borders / pyramid levels).
    Returns (codes (k,) uint32, valid (k,) bool), strongest-first.
    """
    score = jnp.where(valid_mask, score, jnp.uint8(0))
    keep = nms(score)
    enc = encode_grid(score, keep)
    if log_bucket_size > 0:
        enc = bucket_topk(enc, border, log_bucket_size, bucket_limit)
    return select_topk(enc, k)


def make_level_mask(level_sizes, level_rows, total_height, stride, border,
                    max_x=None):
    """Static (H, W) bool validity mask for a stacked pyramid.

    Valid pixels of level l (row r, size (w, h)):
    rows [r+border, r+h-border), cols [border, w-border) -- the reference's
    per-level loop bounds (Fast.h:60-61, 171-172, 210, 228).
    """
    m = np.zeros((total_height, stride), bool)
    for (w, h), r in zip(level_sizes, level_rows):
        m[r + border:r + h - border, border:w - border] = True
    if max_x is not None:
        m[:, max_x:] = False
    return m
