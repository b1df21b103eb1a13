"""Demo-pyramid golden parity: the production pipeline must reproduce the
literal-oracle output on the REAL reference demo pyramid byte-for-byte.

The reference's de-facto integration test is its demo binary's feature
count/output on demo/input.png (demo.cpp:103-115). The binary is ARM32-only,
so the grounded equivalent is tests/golden/demo_golden.npz: the per-pixel
reference-semantics oracle chain (tests/oracles.py) run once over the full
640x2210 pyramid by tools/make_demo_golden.py. This test asserts the
production `make_extract_fn` pipeline finds the exact same keypoint set with
the exact same angle bins and descriptors. (chip_smoke.py separately
asserts the GPU runs this same pipeline bit-for-bit like the CPU.)
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from pislam_tpu.config import FrontendConfig, PislamConfig
from pislam_tpu.frontend import make_extract_fn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "demo_golden.npz")
DEMO = "/root/reference/demo/input.png"


@pytest.mark.skipif(not os.path.exists(DEMO),
                    reason="reference demo pyramid not present")
def test_demo_pyramid_matches_oracle_golden():
    from PIL import Image

    g = np.load(GOLDEN)
    img = np.asarray(Image.open(DEMO).convert("L"))
    cfg = PislamConfig(frontend=FrontendConfig(
        fast_threshold=int(g["fast_threshold"]),
        harris_threshold=int(g["harris_threshold"]),
        border=int(g["border"]), words=int(g["words"])))
    pc = cfg.pyramid
    assert len(g["codes"]) <= cfg.frontend.max_keypoints, \
        "golden has more keypoints than the extraction capacity"

    stack = np.zeros((pc.padded_height, pc.stride), np.uint8)
    stack[:img.shape[0], :img.shape[1]] = img
    feats = make_extract_fn(cfg)(jnp.asarray(stack))

    valid = np.asarray(feats.valid)
    codes = np.asarray(feats.codes)[valid]
    angles = np.asarray(feats.angles)[valid]
    descs = np.asarray(feats.descriptors)[valid]

    order = np.argsort(codes)
    codes, angles, descs = codes[order], angles[order], descs[order]

    np.testing.assert_array_equal(codes, g["codes"])
    np.testing.assert_array_equal(angles, g["angles"])
    np.testing.assert_array_equal(descs, g["descriptors"])
