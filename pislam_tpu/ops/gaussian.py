"""Gaussian 5x5 binomial blur, integer-exact RHADD semantics.

The reference implements the separable [1 4 6 4 1]/16 filter exclusively with
NEON vrhadd (round-halving-add) in a proven exact rewriting (reference
Gaussian.h:51-72); its gtest golden model *is* that RHADD chain
(GaussianTest.cpp:159-215). We keep the identical integer semantics -- so the
blur is byte-exact against the reference -- but express it as a dense, whole-
image vector program: per axis,

    out = RHADD(RHADD(RHADD(RHADD(a, e), c), c), RHADD(b, d))

with (a, b, c, d, e) = pixels at offsets (-2, -1, 0, +1, +2) and reflect-101
borders (GaussianTest.cpp:163-186: at i=0 the window is [m2, m1, m0, m1, m2];
at the bottom e reflects to m[h-2] then m[h-3]).

RHADD(a, b) == (a + b + 1) >> 1 (rounding-up halving add). Computed in uint16
to stay exact; images are uint8 HBM-resident.

Unlike the NEON version there is no padding requirement (no 8x16 block
machinery, no hstore strip, none of the 17 odd-size asm edge paths --
XLA's shape discipline dissolves those concerns, SURVEY.md section 5).
Requires width >= 3 and height >= 3 for the reflection to be defined
(reference requires >= 16x16).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _rhadd(a, b):
    """vrhadd: (a + b + 1) >> 1, exact in uint16."""
    return (a + b + jnp.uint16(1)) >> 1


def _rhadd_chain(a, b, c, d, e):
    """The exact vrhadd rewriting of [1 4 6 4 1]/16 (Gaussian.h:51-72)."""
    x = _rhadd(a, e)
    y = _rhadd(b, d)
    x = _rhadd(x, c)
    x = _rhadd(x, c)
    return _rhadd(x, y)


def _shifts(img, axis):
    """Five static offset views (-2..+2) along ``axis`` of a 2-padded image.

    Static slices (unlike index-array gathers) fuse into the consuming
    elementwise chain, so the whole blur compiles to pad + one fused
    elementwise loop instead of eight materialised gathers.
    """
    n = img.shape[axis] - 4
    return tuple(
        jax.lax.slice_in_dim(img, k, k + n, axis=axis) for k in range(5)
    )


def gaussian5x5(img):
    """Blur a (..., H, W) uint8 image; byte-exact vs reference gaussian5x5.

    Vertical pass then horizontal pass, exactly like the golden model
    (GaussianTest.cpp:159-215), with reflect-101 borders (index -1 -> 1,
    -2 -> 2, h -> h-2, h+1 -> h-3; jnp.pad mode='reflect' is exactly this
    map). Reflection in x commutes with blurring in y, so one 2-D pad up
    front serves both passes. Batch dims broadcast.
    """
    pad = [(0, 0)] * (img.ndim - 2) + [(2, 2), (2, 2)]
    x = jnp.pad(img.astype(jnp.uint16), pad, mode="reflect")
    x = _rhadd_chain(*_shifts(x, axis=-2))   # (..., H, W+4)
    x = _rhadd_chain(*_shifts(x, axis=-1))   # (..., H, W)
    return x.astype(jnp.uint8)
