"""Bilinear pyramid downscale kernels: 7/8, 13/16, and general resize.

The reference ships two fixed-ratio NEON resamplers whose exact fixed-point
semantics are specified by scalar golden models in its tests:

* bilinear7_8: 8x8 block -> 7x7 block, filter bank
  {238, 201, 165, 128, 91, 55, 18} (reference Bilinear.h:49-52,
  BilinearTest.cpp:171-196).
* bilinear13_16: 16x16 block -> 13x13 block, 13-tap filter bank with two
  "holes" in the source grid mapped by map13 (skips source offsets 4 and 10;
  reference Bilinear.h:172-180, BilinearTest.cpp:198-233).

Both interpolate horizontally between source columns (c, c+1) with weights
(f[x], f[last-x]), round with RSHR (round-half-up: (a>>8) + ((a>>7)&1),
BilinearTest.cpp:35), then interpolate vertically the same way. We reproduce
that integer arithmetic exactly -- byte-exact vs the reference -- as dense
whole-image gathers + multiplies instead of per-block lane shuffles.

Ratio rationale (Bilinear.h:28-31, :153): chains of 7/8 and 13/16 approximate
the 5/6 pyramid step. ``resize_bilinear`` provides a general fixed-point
bilinear resize (half-pixel centers) used to build the demo's exact
round(640*(5/6)^l) level table on-device (the reference delegates this to the
Pi GPU, README.md:28-31; this build brings it in-scope, SURVEY.md section 1).

Inputs must be padded to a multiple of 8 (7/8) or 16 (13/16) in both
dimensions, mirroring the reference's padding contract (Bilinear.h:32, :155).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

FILTER_7_8 = np.array([238, 201, 165, 128, 91, 55, 18], np.int32)
FILTER_13_16 = np.array(
    [226, 167, 108, 49, 246, 187, 128, 69, 10, 207, 138, 89, 30], np.int32
)


def _map13(i: np.ndarray) -> np.ndarray:
    """Source-offset hole map for 13/16 (BilinearTest.cpp:198-206)."""
    i = np.asarray(i)
    i = np.where(i > 3, i + 1, i)
    i = np.where(i > 9, i + 1, i)
    return i


def _rshr8(a):
    """RSHR(a, 8): round-half-up divide by 256 (BilinearTest.cpp:35)."""
    return (a >> 8) + ((a >> 7) & 1)


def _axis_plan(n_in: int, block_in: int, block_out: int, filt: np.ndarray, holes):
    """Static gather plan for one axis: source index + weights per output idx."""
    assert n_in % block_in == 0, (
        f"dimension {n_in} must be padded to a multiple of {block_in} "
        "(reference Bilinear.h:32,:155)"
    )
    nblocks = n_in // block_in
    o = np.arange(nblocks * block_out)
    blk, off = o // block_out, o % block_out
    src_off = _map13(off) if holes else off
    idx = blk * block_in + src_off
    w0 = filt[off]
    w1 = filt[block_out - 1 - off]
    return idx, w0, w1


def _downscale(img, block_in: int, block_out: int, filt: np.ndarray, holes: bool):
    h, w = img.shape[-2], img.shape[-1]
    yidx, yw0, yw1 = _axis_plan(h, block_in, block_out, filt, holes)
    xidx, xw0, xw1 = _axis_plan(w, block_in, block_out, filt, holes)

    x = img.astype(jnp.int32)
    # horizontal: h = RSHR(p[c]*w0 + p[c+1]*w1, 8) for every input row
    p0 = jnp.take(x, jnp.asarray(xidx), axis=-1)
    p1 = jnp.take(x, jnp.asarray(xidx + 1), axis=-1)
    hrow = _rshr8(p0 * jnp.asarray(xw0) + p1 * jnp.asarray(xw1))
    # vertical on the horizontally-interpolated rows
    r0 = jnp.take(hrow, jnp.asarray(yidx), axis=-2)
    r1 = jnp.take(hrow, jnp.asarray(yidx + 1), axis=-2)
    out = _rshr8(r0 * jnp.asarray(yw0)[:, None] + r1 * jnp.asarray(yw1)[:, None])
    return out.astype(jnp.uint8)


def bilinear7_8(img):
    """(..., H, W) uint8 -> (..., H*7//8, W*7//8); byte-exact vs reference.

    H and W must be multiples of 8. For an unpadded original size s, the
    valid output region is floor(s*7/8) (Bilinear.h:34-36).
    """
    return _downscale(img, 8, 7, FILTER_7_8, holes=False)


def bilinear13_16(img):
    """(..., H, W) uint8 -> (..., H*13//16, W*13//16); byte-exact vs reference.

    H and W must be multiples of 16. Valid region floor(s*13/16)
    (Bilinear.h:157-158).
    """
    return _downscale(img, 16, 13, FILTER_13_16, holes=True)


def resize_bilinear(img, out_h: int, out_w: int):
    """General fixed-point bilinear resize with half-pixel-centred sampling.

    Used for the 5/6-per-level pyramid (demo.cpp:38-47 level table). The
    reference builds pyramids off-CPU with unspecified semantics
    (README.md:28-31), so no bit-parity target exists; we use the standard
    OpenCV-style convention: src = (dst + 0.5) * scale - 0.5, clamped, with
    8-bit fixed-point weights and round-half-up -- deterministic and
    integer-exact across platforms.
    """
    h, w = img.shape[-2], img.shape[-1]

    def plan(n_in, n_out):
        scale = n_in / n_out
        src = (np.arange(n_out) + 0.5) * scale - 0.5
        src = np.clip(src, 0.0, n_in - 1)
        i0 = np.floor(src).astype(np.int32)
        i0 = np.clip(i0, 0, n_in - 2) if n_in > 1 else np.zeros_like(i0)
        frac = np.round((src - i0) * 256.0).astype(np.int32)
        return i0, 256 - frac, frac

    yi, yw0, yw1 = plan(h, out_h)
    xi, xw0, xw1 = plan(w, out_w)

    x = img.astype(jnp.int32)
    p0 = jnp.take(x, jnp.asarray(xi), axis=-1)
    p1 = jnp.take(x, jnp.asarray(np.minimum(xi + 1, w - 1)), axis=-1)
    hrow = _rshr8(p0 * jnp.asarray(xw0) + p1 * jnp.asarray(xw1))
    r0 = jnp.take(hrow, jnp.asarray(yi), axis=-2)
    r1 = jnp.take(hrow, jnp.asarray(np.minimum(yi + 1, h - 1)), axis=-2)
    out = _rshr8(r0 * jnp.asarray(yw0)[:, None] + r1 * jnp.asarray(yw1)[:, None])
    return jnp.clip(out, 0, 255).astype(jnp.uint8)
