"""Rotated BRIEF (ORB) 256-bit descriptors via a rotation lookup table.

Reference: Brief.h hardcodes the 256 learned OpenCV-ORB point pairs as
template instantiations, rotating each pair at *compile time* into 30
specialised 4KB functions dispatched by a runtime switch (Brief.h:28-53,
637-733). The data-parallel inversion (SURVEY.md section 7) is a precomputed
(30, 256, 2) rotated-coordinate table and one batched gather from the 31x31
patches already fetched for orientation: descriptor bit i is

    patch[idx0[angle, i]] < patch[idx1[angle, i]]        (Brief.h:52)

Rotation semantics reproduced exactly (Brief.h:30-50): theta = rot*pi/15 in
float32, coordinates rotated with float32 cos/sin, roundf (half away from
zero), then clamped to [-15, 15].

Bit packing: word w, bit b -> pattern index 32*w + b; bits OR'd as 1 << b
(Brief.h:71-133). `words` in 1..8 selects 32..256-bit descriptors
(Orb.h:389-392).

Compute formulation: instead of 512 per-keypoint sample gathers,
descriptor bit (rot, i) is evaluated as

    sign( patch_flat . (onehot(idx1[rot,i]) - onehot(idx0[rot,i])) ) > 0

i.e. ONE (K, 961) x (961, 30*256) matmul against a constant {-1,0,+1} int8
matrix computes p1 - p0 for every bit of every rotation (exact in
int32), followed by a per-keypoint angle select. Offset-invariant, so it
accepts both uint8 patches and the int8 (pixel-128) patches produced by
patches.gather_patches_s8.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ._brief_pattern import BRIEF_PATTERN
from .patches import RADIUS, PATCH

N_ROT = 30
N_BITS = 256


def _round_half_away(x):
    """C roundf: round half away from zero."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def _rotation_tables():
    """(30, 256) flat patch indices for point 0 and point 1."""
    pat = np.array(BRIEF_PATTERN, np.int32)  # (256, 4): dx0, dy0, dx1, dy1
    idx0 = np.zeros((N_ROT, N_BITS), np.int32)
    idx1 = np.zeros((N_ROT, N_BITS), np.int32)
    for rot in range(N_ROT):
        theta = np.float32(rot * np.pi / 15)
        c = np.float32(np.cos(theta))
        s = np.float32(np.sin(theta))
        dx0, dy0, dx1, dy1 = (pat[:, i].astype(np.float32) for i in range(4))
        rdx0 = np.clip(_round_half_away(c * dx0 - s * dy0), -15, 15).astype(np.int32)
        rdy0 = np.clip(_round_half_away(s * dx0 + c * dy0), -15, 15).astype(np.int32)
        rdx1 = np.clip(_round_half_away(c * dx1 - s * dy1), -15, 15).astype(np.int32)
        rdy1 = np.clip(_round_half_away(s * dx1 + c * dy1), -15, 15).astype(np.int32)
        idx0[rot] = (rdy0 + RADIUS) * PATCH + (rdx0 + RADIUS)
        idx1[rot] = (rdy1 + RADIUS) * PATCH + (rdx1 + RADIUS)
    return idx0, idx1

IDX0, IDX1 = _rotation_tables()


def _diff_matrix() -> np.ndarray:
    """(961, 30*256) int8: column (rot*256+i) = onehot(idx1) - onehot(idx0)."""
    g = np.zeros((PATCH * PATCH, N_ROT * N_BITS), np.int8)
    for rot in range(N_ROT):
        cols = rot * N_BITS + np.arange(N_BITS)
        np.add.at(g, (IDX1[rot], cols), 1)
        np.subtract.at(g, (IDX0[rot], cols), 1)
    return g

GDIFF = _diff_matrix()


def _bits_to_words(dsel, words: int):
    k = dsel.shape[0]
    bits = (dsel > 0).astype(jnp.uint32)
    bits = bits[:, : words * 32].reshape(k, words, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(bits << shifts, axis=-1, dtype=jnp.uint32)


def describe_packed(flat, angles, words: int = 8):
    """(K, 1024) packed int8 windows + (K,) angle bins -> (K, words) u32.

    Same computation as `describe` with GDIFF rows remapped to the packed
    window layout (patches.packed_index_map)."""
    from .patches import remap_weights_packed

    g = jnp.asarray(remap_weights_packed(GDIFF))
    k = flat.shape[0]
    diff = jax.lax.dot_general(
        flat, g, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).reshape(k, N_ROT, N_BITS)
    sel = (angles.astype(jnp.int32)[:, None]
           == jnp.arange(N_ROT, dtype=jnp.int32)[None, :])
    dsel = jnp.sum(diff * sel[:, :, None].astype(diff.dtype), axis=1)
    return _bits_to_words(dsel, words)


def orb_compute_packed(flat, words: int = 8):
    """Fused orientation + descriptors from packed windows.

    (K, 1024) packed int8 windows -> ((K,) uint8 angle bins, (K, words) u32).

    One int8 matmul computes the p1-p0 differences for all 30 rotations AND
    the image moments (the centroid weight columns ride along as two extra
    int8 columns), then each keypoint selects its own rotation. Bit-exact
    vs centroids_packed + atan2_bins + describe_packed.
    """
    from .patches import remap_weights_packed
    from .orientation import MOMENT_WEIGHTS, atan2_bins

    k = flat.shape[0]
    g = remap_weights_packed(GDIFF)                     # (1024, 7680) i8
    mw = remap_weights_packed(
        MOMENT_WEIGHTS.astype(np.int8))                 # (1024, 2) i8
    gm = jnp.asarray(np.concatenate([g, mw], axis=1))   # (1024, 7682)

    out = jax.lax.dot_general(
        flat, gm, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    m10 = out[:, N_ROT * N_BITS]
    m01 = out[:, N_ROT * N_BITS + 1]
    angles = atan2_bins(m10, m01)
    diff = out[:, : N_ROT * N_BITS].reshape(k, N_ROT, N_BITS)
    sel = (angles.astype(jnp.int32)[:, None]
           == jnp.arange(N_ROT, dtype=jnp.int32)[None, :])
    dsel = jnp.sum(diff * sel[:, :, None].astype(diff.dtype), axis=1)
    return angles, _bits_to_words(dsel, words)


def describe(patches, angles, words: int = 8):
    """(K, 31, 31) patches + (K,) uint8 angle bins -> (K, words) uint32.

    Equivalent to briefDescribe over every keypoint (orbCompute's 15-pass
    I-cache trick, Orb.h:402-421, is irrelevant here: all 30 rotations are
    one matmul). Accepts uint8 or offset int8 patches (see module doc).
    """
    k = patches.shape[0]
    flat = patches.reshape(k, PATCH * PATCH)
    if flat.dtype == jnp.int8:
        lhs, rhs = flat, jnp.asarray(GDIFF)
    else:
        lhs, rhs = flat.astype(jnp.float32), jnp.asarray(GDIFF, jnp.float32)
    diff = jax.lax.dot_general(
        lhs, rhs,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32 if lhs.dtype == jnp.int8 else jnp.float32,
    )  # (K, 30*256): p1 - p0 per (rot, bit)
    diff = diff.reshape(k, N_ROT, N_BITS)
    sel = (angles.astype(jnp.int32)[:, None]
           == jnp.arange(N_ROT, dtype=jnp.int32)[None, :])
    dsel = jnp.sum(diff * sel[:, :, None].astype(diff.dtype), axis=1)  # (K, 256)
    bits = (dsel > 0).astype(jnp.uint32)
    bits = bits[:, : words * 32].reshape(k, words, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(bits << shifts, axis=-1, dtype=jnp.uint32)
