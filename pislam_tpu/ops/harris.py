"""Harris corner scoring with the reference's exact integer semantics, dense.

Reference: harrisScoreSobel / harrisEval (Harris.h:37-248). The reference
computes, per candidate, halving-add Sobel derivatives over an 8x8 patch and a
6x6 structure tensor; every step is translation-invariant, so the whole thing
reformulates as dense whole-image arithmetic (then masked by the FAST mask,
mirroring fastScoreHarris's sparse sweep, Fast.h:166-180 -- dense
compute over the whole image avoids a per-candidate gather).

Exact semantic chain reproduced bit-for-bit:

  hd[y,x] = (img[y,x+1] - img[y,x-1]) >> 1          vhsub_u8, Harris.h:139-141
  vd[y,x] = (img[y+1,x] - img[y-1,x]) >> 1          vhsub_u8, Harris.h:124
  dx = hadd(hadd(hd[y-1], hd[y+1]), hd[y])          vhadd_s8, Harris.h:144-146
  dy = hadd(hadd(vd[x-1], vd[x+1]), vd[x])          vhadd_s8, Harris.h:125-128
      (hadd(a,b) = (a+b)>>1 arithmetic; center-last order matters)
  Sxx/Syy/Sxy = sum over the 6x6 window of centers
      {y-2..y+3} x {x-2..x+3}                       Harris.h:164-239
  Ixx = Sxx >> 4 (etc.)                             Harris.h:241-245
  trace2 = uint32((Ixx+Iyy)*(Ixx+Iyy)) >> 4         k = 1/16, Harris.h:40-43
  det   = uint32(Ixx*Iyy) - Ixy*Ixy                 Harris.h:46-50
  score = int32(det - trace2)                       Harris.h:53-57
  qf    = score > threshold ? (f32bits(score) >> 20) & 0xff : 0
                                                    Harris.h:58-68

The 8-bit result is a "quarter-precision float" (5 exponent + 3 fraction bits
ripped out of the IEEE f32 encoding); larger means stronger. All intermediate
arithmetic uses uint32 wrap-around exactly like the NEON code.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .fast import shift2d


def _hadd(a, b):
    """vhadd_s8: (a + b) >> 1 arithmetic (floor); exact in int16."""
    return (a + b) >> 1


def _window6_sum(a):
    """Sum over the 6x6 window of offsets {-2..3} x {-2..3} (Harris.h:216-239)."""
    s = a
    acc = s
    for u in (-2, -1, 1, 2, 3):
        acc = acc + shift2d(s, 0, u)
    acc2 = acc
    for v in (-2, -1, 1, 2, 3):
        acc2 = acc2 + shift2d(acc, v, 0)
    return acc2


def harris_response(img):
    """(..., H, W) uint8 -> int32 Harris response (det - trace^2/16)."""
    x = img.astype(jnp.int16)

    hd = (shift2d(x, 0, 1) - shift2d(x, 0, -1)) >> 1
    vd = (shift2d(x, 1, 0) - shift2d(x, -1, 0)) >> 1

    dx = _hadd(_hadd(shift2d(hd, -1, 0), shift2d(hd, 1, 0)), hd).astype(jnp.int32)
    dy = _hadd(_hadd(shift2d(vd, 0, -1), shift2d(vd, 0, 1)), vd).astype(jnp.int32)

    sxx = _window6_sum(dx * dx)
    syy = _window6_sum(dy * dy)
    sxy = _window6_sum(dx * dy)

    ixx = (sxx >> 4).astype(jnp.uint32)
    iyy = (syy >> 4).astype(jnp.uint32)
    ixy = sxy >> 4  # arithmetic shift, signed (vshr_n_s32, Harris.h:245)

    trace = ixx + iyy
    trace2 = (trace * trace) >> 4  # uint32 wrap semantics (Harris.h:41-43)
    det = ixx * iyy - ixy.astype(jnp.uint32) * ixy.astype(jnp.uint32)
    score = (det - trace2).astype(jnp.int32)
    return score


def quarter_float(score_i32):
    """int32 score -> uint8 quarter-precision float (Harris.h:58-66)."""
    f = score_i32.astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(f, jnp.uint32)
    return ((bits >> 20) & jnp.uint32(0xFF)).astype(jnp.uint8)


def harris_score(img, threshold: int, mask=None):
    """Dense equivalent of fastScoreHarris (Fast.h:166-180).

    Returns a uint8 quarter-float score map: qf(score) where
    (mask & (score > threshold)), else 0.
    """
    score = harris_response(img)
    qf = quarter_float(score)
    keep = score > jnp.int32(threshold)
    if mask is not None:
        keep = keep & mask
    return jnp.where(keep, qf, jnp.uint8(0))
