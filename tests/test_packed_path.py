"""The packed-window path must be bit-identical to the plain path.

The frontend gathers 32x32 windows in a packed byte layout (four rows
interleaved per column; patches.packed_index_map) and runs orientation/BRIEF
with remapped weight matrices; these tests pin the layout contract and the
consumer parity against the plain (K, 31, 31) patch path.
"""

import numpy as np
import jax.numpy as jnp

from pislam_tpu.ops import brief, nms, orientation, patches


def _random_setup(seed=0, h=256, w=384, k=64):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w), np.uint8)
    xs = rng.integers(16, w - 16, k).astype(np.int32)
    ys = rng.integers(16, h - 16, k).astype(np.int32)
    valid = rng.random(k) < 0.9
    return img, xs, ys, valid


def test_packed_layout_contract():
    img, xs, ys, valid = _random_setup()
    flat = np.asarray(patches.gather_patches_packed_s8(
        jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys),
        jnp.asarray(valid)))
    idx = patches.packed_index_map()
    for k in np.flatnonzero(valid)[:8]:
        win = img[ys[k] - 15:ys[k] + 17, xs[k] - 15:xs[k] + 17]
        got = flat[k][idx.reshape(-1)].reshape(31, 31)
        expect = (win[:31, :31].astype(np.int16) - 128).astype(np.int8)
        assert np.array_equal(got, expect)


def test_packed_consumers_match_plain():
    img, xs, ys, valid = _random_setup(seed=3)
    ji, jx, jy, jv = map(jnp.asarray, (img, xs, ys, valid))
    p31 = patches.gather_patches_s8(ji, jx, jy, jv)
    flat = patches.gather_patches_packed_s8(ji, jx, jy, jv)

    m10a, m01a = orientation.centroids(p31)
    m10b, m01b = orientation.centroids_packed(flat)
    va = valid
    assert np.array_equal(np.asarray(m10a)[va], np.asarray(m10b)[va])
    assert np.array_equal(np.asarray(m01a)[va], np.asarray(m01b)[va])

    ang = orientation.atan2_bins(m10a, m01a)
    da = np.asarray(brief.describe(p31, ang, 8))
    db = np.asarray(brief.describe_packed(flat, ang, 8))
    assert np.array_equal(da[va], db[va])


def test_select_topk_scored_matches_select_topk():
    rng = np.random.default_rng(7)
    h, w, k = 128, 256, 128
    # sparse NMS-like survivor grid (select_topk_scored makes no
    # assumption about survivor spacing)
    scored = np.zeros((h, w), np.uint8)
    ys = rng.integers(2, h - 2, 300)
    xs = rng.integers(2, w - 2, 300)
    scored[ys, xs] = rng.integers(1, 256, 300).astype(np.uint8)

    enc = nms.encode_grid(jnp.asarray(scored), jnp.asarray(scored > 0))
    c1, v1 = nms.select_topk(enc, k)
    c2, v2 = nms.select_topk_scored(jnp.asarray(scored), k)
    assert np.array_equal(np.asarray(c1), np.asarray(c2))
    assert np.array_equal(np.asarray(v1), np.asarray(v2))
