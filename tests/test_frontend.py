"""End-to-end frontend parity on a small synthetic stacked pyramid.

Mirrors the reference demo's pipeline (demo.cpp:78-101): per-level
detect/score/extract with global-y re-encoding, then whole-pyramid ORB.
The oracle chain is the literal per-pixel implementation.
"""

import dataclasses

import numpy as np
import pytest

import oracles
from pislam_tpu.config import FrontendConfig, PislamConfig, PyramidConfig
from pislam_tpu.frontend import make_extract_fn


def small_config():
    pyr = PyramidConfig(base_width=96, base_height=80, num_levels=2)
    fe = FrontendConfig(fast_threshold=20, harris_threshold=1 << 10,
                        border=16, max_keypoints=512)
    return PislamConfig(pyramid=pyr, frontend=fe)


def build_stack(cfg):
    pc = cfg.pyramid
    stack = np.zeros((pc.padded_height, pc.stride), np.uint8)
    for (w, h), r in zip(pc.level_sizes, pc.level_rows):
        stack[r:r + h, :w] = oracles.make_test_image(h, w, seed=r + 1)
    return stack


def oracle_pipeline(stack, cfg):
    pc, fc = cfg.pyramid, cfg.frontend
    points = []
    for (w, h), r in zip(pc.level_sizes, pc.level_rows):
        img = stack[r:r + h, :w]
        mask = oracles.fast_detect(img, fc.fast_threshold, fc.border)
        score = oracles.fast_score_harris(img, mask, fc.harris_threshold,
                                          fc.border)
        pts = oracles.fast_extract(score, fc.border, fc.log_bucket_size,
                                   fc.bucket_limit)
        for p in pts:
            s, x, y = p >> 24, (p >> 12) & 0xFFF, p & 0xFFF
            points.append((s << 24) | (x << 12) | (y + r))
    feats = {}
    for p in points:
        x, y = (p >> 12) & 0xFFF, p & 0xFFF
        m10, m01 = oracles.centroid(stack, x, y)
        ang = oracles.atan2_bin(m10, m01)
        desc = tuple(
            w & 0xFFFFFFFF
            for w in oracles.brief_describe(stack, x, y, ang, fc.words)
        )
        feats[p] = (ang, desc)
    return feats


def test_end_to_end_parity():
    cfg = small_config()
    extract = make_extract_fn(cfg)
    stack = build_stack(cfg)
    out = extract(stack)

    want = oracle_pipeline(stack, cfg)

    valid = np.asarray(out.valid)
    codes = np.asarray(out.codes)[valid]
    angles = np.asarray(out.angles)[valid]
    descs = np.asarray(out.descriptors)[valid]

    assert len(want) > 5, "test pyramid should produce keypoints"
    assert set(codes.tolist()) == set(want.keys())

    for i, code in enumerate(codes.tolist()):
        wang, wdesc = want[code]
        assert angles[i] == wang, (hex(code), angles[i], wang)
        assert tuple(descs[i].tolist()) == wdesc, hex(code)


def test_strongest_first_and_capacity():
    cfg = small_config()
    cfg2 = PislamConfig(
        pyramid=cfg.pyramid,
        frontend=dataclasses.replace(cfg.frontend, max_keypoints=8),
    )
    stack = build_stack(cfg)
    all_feats = make_extract_fn(cfg)(stack)
    top8 = make_extract_fn(cfg2)(stack)
    codes_all = np.asarray(all_feats.codes)[np.asarray(all_feats.valid)]
    codes_8 = np.asarray(top8.codes)[np.asarray(top8.valid)]
    assert len(codes_8) == min(8, len(codes_all))
    assert codes_8.tolist() == sorted(codes_all.tolist(), reverse=True)[: len(codes_8)]


def test_extract_single_level_padding_invariance():
    """The lane/sublane padding the wrapper adds must not change features."""
    import numpy as np
    import jax.numpy as jnp

    from pislam_tpu.config import PislamConfig
    from pislam_tpu.frontend import _extract_impl, extract_single_level

    rng = np.random.default_rng(3)
    h, w = 120, 300                      # neither dimension aligned
    img = rng.integers(0, 256, (h, w), np.uint8)
    cfg = PislamConfig()
    b = cfg.frontend.border

    got = extract_single_level(jnp.asarray(img), cfg)

    ph, pw = 128, 384                    # manual round_up(8) / round_up(128)
    padded = np.zeros((ph, pw), np.uint8)
    padded[:h, :w] = img
    m = np.zeros((ph, pw), bool)
    m[b:h - b, b:w - b] = True
    expect = _extract_impl(jnp.asarray(padded), m, cfg)

    gv = np.asarray(got.valid)
    ev = np.asarray(expect.valid)
    assert np.array_equal(np.asarray(got.codes)[gv],
                          np.asarray(expect.codes)[ev])
    assert np.array_equal(np.asarray(got.descriptors)[gv],
                          np.asarray(expect.descriptors)[ev])
    xs, ys = np.asarray(got.xs)[gv], np.asarray(got.ys)[gv]
    assert gv.sum() > 0
    assert (xs >= b).all() and (xs < w - b).all()
    assert (ys >= b).all() and (ys < h - b).all()


@pytest.mark.parametrize("lbs,limit", [(3, 2), (4, 5), (5, 1)])
def test_bucketed_extraction_matches_oracle(lbs, limit):
    """Spatial bucketing through the whole frontend (FAST, Harris, NMS,
    per-cell cap, ORB) == the literal per-pixel oracle chain with the
    reference's bucket scan (Fast.h:316-341), feature for feature."""
    pyr = PyramidConfig(base_width=96, base_height=80, num_levels=1)
    fe = FrontendConfig(fast_threshold=20, harris_threshold=1 << 10,
                        border=16, max_keypoints=512, log_bucket_size=lbs,
                        bucket_limit=limit)
    cfg = PislamConfig(pyramid=pyr, frontend=fe)
    stack = build_stack(cfg)
    out = make_extract_fn(cfg)(stack)
    want = oracle_pipeline(stack, cfg)
    valid = np.asarray(out.valid)
    codes = np.asarray(out.codes)[valid].tolist()
    assert len(want) > 0
    assert set(codes) == set(want)
    for i, code in enumerate(codes):
        assert out.angles[valid][i] == want[code][0], hex(code)
        assert tuple(np.asarray(out.descriptors)[valid][i].tolist()) \
            == want[code][1], hex(code)
