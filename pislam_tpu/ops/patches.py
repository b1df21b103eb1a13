"""Per-keypoint 31x31 patch gathers.

The reference's per-feature stages (orbCentroids' disc moments, Orb.h:80-308,
and the BRIEF compares, Brief.h:28-53) read the 31x31 window around each
keypoint. Two layouts are provided:

* ``gather_patches_s8``: (K, 31, 31) patches -- one (32, SLAB) slab per
  keypoint with vmap(dynamic_slice), then the 31 patch columns picked by a
  per-keypoint one-hot (SLAB, 31) int8 matmul (exact in int32). Used by the
  unpacked reference path (orientation.centroids / brief.describe).
* ``gather_patches_packed_s8``: (K, 1024) packed 32x32 windows, the
  production frontend's layout (see below).

Patches are returned as int8 **offset by -128** (value = I - 128, an
order-preserving bijection of uint8). Both consumers are offset-invariant:
disc moments use zero-sum weights (sum w = 0 over the symmetric disc) and
BRIEF compares differences; see orientation.py / brief.py.

Invalid keypoints are redirected to a safe interior coordinate; their outputs
are garbage and must be masked by `valid`. Callers must guarantee
border >= 15 clearance for valid keypoints (FrontendConfig asserts
border >= 16), so the clamped slab never actually clips.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

RADIUS = 15
PATCH = 2 * RADIUS + 1  # 31


def gather_patches_s8(img, xs, ys, valid):
    """img (H, W) uint8; xs/ys (K,) int32 -> (K, 31, 31) int8 (= pixel - 128)."""
    h, w = img.shape
    slab_h = 2 * RADIUS + 2  # 32 rows (sublane-aligned height)
    slab_w = min(256, w)
    assert w >= PATCH and h >= slab_h

    safe_x = jnp.where(valid, xs, RADIUS + 1).astype(jnp.int32)
    safe_y = jnp.where(valid, ys, RADIUS + 1).astype(jnp.int32)

    s8 = (img ^ jnp.uint8(0x80)).astype(jnp.int8)
    y0 = jnp.clip(safe_y - RADIUS, 0, h - slab_h)
    x0 = jnp.clip(safe_x - RADIUS, 0, w - slab_w)
    slabs = jax.vmap(
        lambda y, x: jax.lax.dynamic_slice(s8, (y, x), (slab_h, slab_w))
    )(y0, x0)  # (K, 32, SLAB)

    phi = (safe_x - RADIUS) - x0  # lane offset of patch within slab
    csel = (
        jnp.arange(slab_w, dtype=jnp.int32)[None, :, None]
        == (phi[:, None, None] + jnp.arange(PATCH, dtype=jnp.int32)[None, None, :])
    ).astype(jnp.int8)  # (K, SLAB, 31)
    p = jax.lax.dot_general(
        slabs, csel,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )  # (K, 32, 31)
    return p[:, :PATCH, :].astype(jnp.int8)


def gather_patches(img, xs, ys, valid):
    """Raw-pixel variant: (K, 31, 31) uint8. Test/reference helper."""
    p = gather_patches_s8(img, xs, ys, valid)
    return (p.astype(jnp.int16) + 128).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# packed flat windows
# ---------------------------------------------------------------------------
# A 32x32 window (rows y-15..y+16, cols x-15..x+16) stored as 1024 bytes
# with byte (r, c) at index (r >> 2) * 128 + c * 4 + (r & 3): four rows
# interleaved per column. Consumers (orientation/brief) use weight matrices
# remapped to this layout, so no transpose/unpack ever materialises.

def packed_index_map() -> "np.ndarray":
    """(31, 31) -> flat packed index for weight-matrix remapping."""
    import numpy as np
    r = np.arange(31)[:, None]
    c = np.arange(31)[None, :]
    return (r >> 2) * 128 + c * 4 + (r & 3)


def remap_weights_packed(w961):
    """(961, n) weight matrix over r*31+c -> (1024, n) over packed layout."""
    import numpy as np
    w961 = np.asarray(w961)
    out = np.zeros((1024,) + w961.shape[1:], w961.dtype)
    out[packed_index_map().reshape(-1)] = w961
    return out


def gather_patches_packed_s8(img, xs, ys, valid):
    """(K, 1024) int8 packed windows, offset by -128 (value = I - 128).

    One vmapped (32, 32) dynamic slice per keypoint, relaid to the packed
    order. Invalid keypoints read a safe interior window (mask by `valid`).
    """
    h, w = img.shape
    safe_x = jnp.clip(jnp.where(valid, xs, RADIUS + 1),
                      RADIUS, w - RADIUS - 2).astype(jnp.int32)
    safe_y = jnp.clip(jnp.where(valid, ys, RADIUS + 1),
                      RADIUS, h - RADIUS - 2).astype(jnp.int32)
    win = jax.vmap(
        lambda y, x: jax.lax.dynamic_slice(
            img, (y - RADIUS, x - RADIUS), (32, 32))
    )(safe_y, safe_x)                                   # (K, 32, 32) u8
    # (K, 8, 4, 32) -> packed (a*128 + c*4 + b)
    flat = win.reshape(-1, 8, 4, 32).transpose(0, 1, 3, 2).reshape(-1, 1024)
    return (flat ^ jnp.uint8(0x80)).astype(jnp.int8)
