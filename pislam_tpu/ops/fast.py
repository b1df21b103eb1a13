"""FAST-9 corner detection as a dense, whole-image vector program.

Reference: fastDetect (Fast.h:54-158) -- a branchless NEON segment test on the
16-pixel Bresenham radius-3 circle. Its bit logic was verified (SURVEY.md
section 2, component 2) to implement *exact* FAST-9: a pixel is a corner iff
some circular arc of >= 9 contiguous circle pixels is uniformly darker than
center - t or uniformly lighter than center + t, where

  dark  pass at ring position p:  img[p] <  saturate_u8(c - t)   (Fast.h:64,67)
  light pass at ring position p:  img[p] >  saturate_u8(c + t)   (Fast.h:63,68)

In signed int16 arithmetic the saturation is automatic (img[p] < c - t is
never true when c - t < 0, exactly as img[p] < 0 is never true), so we compute
the 16 ring tests with 16 shifted views + compares, pack them into a 16-bit
ring mask per pixel, and find a length-9 circular run with a logarithmic
shift-AND reduction -- the data-parallel inversion of the reference's
clz-based run test (Fast.h:138-147).

The reference's "classify 15 extra pixels past width" overwrite contract
(Fast.h:36-40) dissolves under XLA shape discipline: we return a full-image
boolean mask and callers apply the border/level validity mask.
"""

from __future__ import annotations

import jax.numpy as jnp

# The 16 ring offsets (dy, dx) in circular order. Decoded from the d0/d1
# half-ring bit insertion order of Fast.h:62-128 (d0 bits 7..0 then d1 bits
# 7..0 walk the circle contiguously).
RING = (
    (-3, -1), (-3, 0), (-3, 1), (-2, 2),
    (-1, 3), (0, 3), (1, 3), (2, 2),
    (3, 1), (3, 0), (3, -1), (2, -2),
    (1, -3), (0, -3), (-1, -3), (-2, -2),
)


def shift2d(a, dy: int, dx: int):
    """shift2d(a, dy, dx)[..., y, x] = a[..., y+dy, x+dx], wrapping at edges.

    Wrapped values land only inside the border region, which every caller
    masks off (border >= 3 for FAST, Fast.h:46-49).
    """
    return jnp.roll(a, (-dy, -dx), axis=(-2, -1))


def _has_run9(bits):
    """True where the 16-bit circular ring mask contains a run of >= 9 ones.

    bits: int32 with ring mask in bits [0, 16). Duplicate into 32 bits so
    circular runs become linear, then AND-reduce shifted copies:
    runs >= 1 -> 2 -> 4 -> 8 -> 9.
    """
    r = bits | (bits << 16)
    r &= r >> 1
    r &= r >> 2
    r &= r >> 4
    r &= r >> 1
    return (r & 0xFFFF) != 0


def fast_detect(img, threshold: int):
    """(..., H, W) uint8 -> bool corner mask (exact FAST-9 semantics).

    Equivalent to reference fastDetect's 0xff/0x00 mask (Fast.h:55) restricted
    to the valid interior; callers mask borders.
    """
    c = img.astype(jnp.int16)
    dark_th = c - jnp.int16(threshold)   # pass-dark:  ring < c - t
    light_th = c + jnp.int16(threshold)  # pass-light: ring > c + t

    dark_bits = jnp.zeros(img.shape, jnp.int32)
    light_bits = jnp.zeros(img.shape, jnp.int32)
    for p, (dy, dx) in enumerate(RING):
        s = shift2d(img, dy, dx).astype(jnp.int16)
        dark_bits |= (s < dark_th).astype(jnp.int32) << p
        light_bits |= (s > light_th).astype(jnp.int32) << p

    return _has_run9(dark_bits) | _has_run9(light_bits)
