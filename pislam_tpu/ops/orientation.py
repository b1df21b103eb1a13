"""Intensity-centroid orientation: disc moments + discretised atan2.

Reference: orbCentroids (Orb.h:80-308) computes image moments m10 = sum(x*I),
m01 = sum(y*I) over a radius-15 disc via four 8-wide column strips with
per-row compare-generated masks; pislam::atan2 (Orb.h:310-387) converts the
moment vector to a discrete angle bin in [0, 30) (12-degree resolution,
README.md:105) with a 2-term polynomial atan approximation.

Here the strip machinery inverts into a single (K, 961) x (961, 2) matmul
against precomputed weight columns [x * disc(x,y), y * disc(x,y)].
Exactness: products <= 255*15 and moment magnitudes < 2^24, so float32
accumulation is integer-exact, matching the reference's int32 moments
bit-for-bit.

The disc shape is decoded from the reference's row masks (leftMask/rightMask
= {5,7,9,10,11,12,13,13}/{13,12,11,10,9,7,5,0} plus the unmasked/setlane rows,
Orb.h:117-121, 151-290): pixel (dx, dy) is in the disc iff |dy| <= VMAX[|dx|].

atan2 deviation from reference: we divide exactly where the NEON code uses
vrecpeq (an ~8-bit reciprocal *estimate*, Orb.h:329); bins can differ only
near bin boundaries, within the reference's own documented error envelope
(avg err 0.054 deg, misclassifies 1/273, Orb.h:344-345).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .patches import RADIUS, PATCH

# Max |dy| per |dx|; decoded from Orb.h:117-121 + strip row layout.
VMAX = np.array([15, 15, 15, 15, 15, 15, 14, 14, 13, 13, 12, 11, 10, 9, 7, 5])


def disc_mask() -> np.ndarray:
    """(31, 31) bool: the reference's exact sampling disc."""
    d = np.arange(-RADIUS, RADIUS + 1)
    dx = d[None, :]
    dy = d[:, None]
    return np.abs(dy) <= VMAX[np.clip(np.abs(dx), 0, 15)]


def _moment_weights() -> np.ndarray:
    """(961, 2) float32 weight matrix [x*disc, y*disc]."""
    d = np.arange(-RADIUS, RADIUS + 1)
    m = disc_mask()
    wx = (m * d[None, :]).astype(np.float32)  # weight = x offset
    wy = (m * d[:, None]).astype(np.float32)  # weight = y offset
    return np.stack([wx.reshape(-1), wy.reshape(-1)], axis=1)

MOMENT_WEIGHTS = _moment_weights()


def centroids_packed(flat):
    """(K, 1024) packed int8 windows -> (K,) m10, (K,) m01 (exact).

    Same math as `centroids` with the weight rows remapped to the packed
    window layout (patches.packed_index_map); window bytes outside the
    31x31 patch get zero weight.
    """
    from .patches import remap_weights_packed

    w = jnp.asarray(remap_weights_packed(MOMENT_WEIGHTS))
    m = jnp.dot(flat.astype(jnp.float32), w,
                preferred_element_type=jnp.float32)
    m = m.astype(jnp.int32)
    return m[:, 0], m[:, 1]


def centroids(patches):
    """(K, 31, 31) patches -> (K,) m10, (K,) m01 int32 (exact, Orb.h:81-308).

    Accepts uint8 pixels or the int8 (pixel-128) patches from
    patches.gather_patches_s8: the disc weight columns sum to zero (the disc
    is symmetric and the weights odd), so the -128 offset cancels exactly.
    """
    k = patches.shape[0]
    p = patches.reshape(k, PATCH * PATCH).astype(jnp.float32)
    m = jnp.dot(p, jnp.asarray(MOMENT_WEIGHTS), preferred_element_type=jnp.float32)
    m = m.astype(jnp.int32)
    return m[:, 0], m[:, 1]


# Polynomial constants, pre-scaled by 60/pi and 256 (Orb.h:333-348).
_C0 = np.float32(256 * 14.999998)
_C1 = np.float32(256 * 4.723436)
_C2 = np.float32(256 * 1.266240)


def atan2_bins(m10, m01):
    """(K,) int32 moments -> (K,) uint8 angle bin in [0, 30) (Orb.h:310-387)."""
    x = m10
    y = m01
    xf = jnp.abs(x.astype(jnp.float32))
    yf = jnp.abs(y.astype(jnp.float32))
    zmax = jnp.maximum(xf, yf)
    zmin = jnp.minimum(xf, yf)
    # exact divide in place of vrecpe estimate (see module docstring)
    z = zmin / jnp.maximum(zmax, jnp.float32(1e-30))
    anglef = z * (_C0 - (z - jnp.float32(1.0)) * (_C1 + _C2 * z))
    angle = anglef.astype(jnp.int32)  # trunc toward zero (vcvtq_s32_f32)

    signs_differ = (x < 0) ^ (y < 0)
    xdom = jnp.abs(x) > jnp.abs(y)

    # |x| > |y| branch (Orb.h:357-365)
    a1 = jnp.where(signs_differ, -angle, angle)
    a1 = jnp.where(x < 0, a1 + 256 * 60, jnp.where(a1 < 0, a1 + 256 * 120, a1))
    # |x| <= |y| branch (Orb.h:366-375)
    a2 = jnp.where(~signs_differ, -angle, angle)
    a2 = jnp.where(y >= 0, a2 + 256 * 30, a2 + 256 * 90)

    out = jnp.where(xdom, a1, a2) >> 10
    # NaN/degenerate guard (Orb.h:378-380)
    out = jnp.where((out >= 0) & (out < 30) & (zmax > 0), out, 0)
    return out.astype(jnp.uint8)
