"""The ORB extraction frontend: one jitted pass over a stacked pyramid.

End-to-end equivalent of the reference demo's per-frame path (demo.cpp:78-101
-> SURVEY.md section 3.1): per-level fastDetect + fastScoreHarris +
fastExtract, then one whole-pyramid orbCompute. Here the per-level loops
vanish: FAST, Harris and NMS run as dense passes over the *entire* stacked
(total_height, stride) buffer at once, and per-level borders become a single
precomputed validity mask. Keypoint y coordinates are global pyramid rows,
exactly like the demo's re-encoding (demo.cpp:92-97).

Output is a fixed-capacity Features batch (static shapes for XLA):

    codes       (K,)  uint32  score<<24 | x<<12 | y (Util.h:27)
    valid       (K,)  bool
    angles      (K,)  uint8   orientation bin in [0, 30)
    descriptors (K, words) uint32

Keypoints are strongest-first by (score, x, y).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import PislamConfig
from .ops import brief, fast, harris, nms, patches
from .utils import codec


class Features(NamedTuple):
    codes: jax.Array        # (K,) uint32
    valid: jax.Array        # (K,) bool
    angles: jax.Array       # (K,) uint8
    descriptors: jax.Array  # (K, words) uint32

    @property
    def xs(self):
        return codec.decode_x(self.codes).astype(jnp.int32)

    @property
    def ys(self):
        return codec.decode_y(self.codes).astype(jnp.int32)

    @property
    def scores(self):
        return codec.decode_score(self.codes).astype(jnp.int32)

    @property
    def num_valid(self):
        return jnp.sum(self.valid.astype(jnp.int32))


def _extract_impl(img, level_mask, cfg: PislamConfig) -> Features:
    fc = cfg.frontend
    corner = fast.fast_detect(img, fc.fast_threshold)
    score = harris.harris_score(img, fc.harris_threshold, mask=corner)
    score = jnp.where(level_mask, score, jnp.uint8(0))
    keep = nms.nms(score)
    if fc.log_bucket_size > 0:
        enc = nms.encode_grid(score, keep)
        enc = nms.bucket_topk(enc, fc.border, fc.log_bucket_size,
                              fc.bucket_limit)
        scored = (enc >> 24).astype(jnp.uint8)
    else:
        scored = jnp.where(keep, score, jnp.uint8(0))
    codes, valid = nms.select_topk_scored(scored, fc.max_keypoints)

    xs = codec.decode_x(codes).astype(jnp.int32)
    ys = codec.decode_y(codes).astype(jnp.int32)
    flat = patches.gather_patches_packed_s8(img, xs, ys, valid)
    angles, desc = brief.orb_compute_packed(flat, fc.words)
    desc = jnp.where(valid[:, None], desc, jnp.uint32(0))
    angles = jnp.where(valid, angles, jnp.uint8(0))
    return Features(codes=codes, valid=valid, angles=angles, descriptors=desc)


def make_extract_fn(cfg: PislamConfig):
    """Build a jitted extract(pyramid_stacked) -> Features for a config.

    ``pyramid_stacked`` is (padded_height, stride) uint8: the vertically
    stacked pyramid (README.md:56-83 layout). The per-level border validity
    mask is baked in as a compile-time constant.
    """
    pc = cfg.pyramid
    mask = nms.make_level_mask(
        pc.level_sizes, pc.level_rows, pc.padded_height, pc.stride,
        cfg.frontend.border,
    )

    @jax.jit
    def extract(img):
        assert img.shape == (pc.padded_height, pc.stride), (
            f"expected {(pc.padded_height, pc.stride)}, got {img.shape}"
        )
        return _extract_impl(img, mask, cfg)

    return extract


def extract_single_level(img, cfg: PislamConfig) -> Features:
    """Extraction over one plain (H, W) image (no pyramid): test/VO helper.

    The image is zero-padded to the stacked-pyramid alignment (width to a
    multiple of 128, height to a multiple of 8); the
    validity mask keeps the original border, so the padding never changes
    which features are found (all reads from a valid keypoint stay >= 16
    pixels inside the original image).
    """
    from .config import round_up

    h, w = img.shape
    b = cfg.frontend.border
    ph, pw = round_up(h, 8), max(round_up(w, 128), 256)
    if (ph, pw) != (h, w):
        img = jnp.pad(img, ((0, ph - h), (0, pw - w)))
    m = np.zeros((ph, pw), bool)
    m[b:h - b, b:w - b] = True
    return _extract_impl(img, m, cfg)
