"""Config layer: JSON round-trip, validation, demo level-table parity.

The reference's configuration is compile-time template parameters plus two
runtime thresholds and a hardcoded level table (demo.cpp:38-47,
SURVEY.md section 5); the framework replaces it with frozen dataclasses.
"""

import dataclasses

import pytest

from pislam_tpu.config import FrontendConfig, PislamConfig, PyramidConfig


def test_json_roundtrip_all_fields():
    cfg = PislamConfig(
        frontend=FrontendConfig(fast_threshold=17, max_keypoints=1024,
                                log_bucket_size=4, bucket_limit=3),
        pyramid=PyramidConfig(base_width=512, base_height=384, num_levels=5),
    )
    back = PislamConfig.from_json(cfg.to_json())
    assert back == cfg
    assert back.frontend.max_keypoints == 1024
    # defaults round-trip too
    d = PislamConfig()
    assert PislamConfig.from_json(d.to_json()) == d


def test_frontend_validation():
    with pytest.raises(AssertionError):
        FrontendConfig(border=8)           # < FAST+Harris+ORB support
    with pytest.raises(AssertionError):
        FrontendConfig(words=9)            # descriptor words in 1..8
    with pytest.raises(AssertionError):
        FrontendConfig(words=0)            # descriptor words in 1..8


def test_demo_level_table():
    """Default pyramid reproduces the reference demo's measured level table
    (demo.cpp:38-47: 640x480 down to 133x100, 8 levels, 2210 total rows)."""
    pc = PyramidConfig()
    assert pc.num_levels == 8
    assert pc.level_sizes[0] == (640, 480)
    assert pc.level_sizes[-1] == (179, 134)
    assert pc.total_height == 2210  # the demo pyramid's stacked height
    # level rows are the running row offsets of the stacked layout
    assert pc.level_rows[0] == 0
    assert pc.level_rows[-1] == 2210 - 134
    assert all(r2 - r1 == h for (r1, r2, (_w, h)) in
               zip(pc.level_rows, pc.level_rows[1:], pc.level_sizes))


def test_configs_are_frozen():
    cfg = PislamConfig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.frontend.fast_threshold = 10
