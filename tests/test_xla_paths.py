"""The plain XLA paths of the frontend, matcher and backend, checked on the
CPU against independent numpy references; plus the compile-cache location,
the matmul precision the package requests, and chip_smoke.py's refusal to
run without a GPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from pislam_tpu import matching
from pislam_tpu.ops import brief, nms, orientation, patches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKED = patches.packed_index_map().reshape(-1)


def _window(img, y, x):
    """The 31x31 patch around (x, y) as int8 (pixel - 128)."""
    w = img[y - 15:y + 16, x - 15:x + 16].astype(np.int16) - 128
    return w.astype(np.int8)


@pytest.mark.parametrize("h,w,k,case", [
    (64, 384, 96, "random"),     # k not a multiple of any block size
    (48, 768, 64, "random"),     # wide frame
    (64, 384, 8, "bottom"),      # keypoints at the lowest legal rows
])
def test_window_gather_matches_numpy(h, w, k, case):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (h, w), np.uint8)
    xs = rng.integers(16, w - 16, k).astype(np.int32)
    ys = rng.integers(16, h - 16, k).astype(np.int32)
    if case == "bottom":
        ys = (h - 17 - np.arange(k) % 4).astype(np.int32)
    valid = rng.random(k) < 0.8
    valid[0] = True
    flat = np.asarray(patches.gather_patches_packed_s8(
        jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys),
        jnp.asarray(valid)))
    assert flat.shape == (k, 1024) and flat.dtype == np.int8
    for i in range(k):
        got = flat[i][PACKED].reshape(31, 31)
        # invalid keypoints read the safe interior window at (16, 16)
        want = (_window(img, ys[i], xs[i]) if valid[i]
                else _window(img, 16, 16))
        assert np.array_equal(got, want), (i, valid[i])


@pytest.mark.parametrize("n,k", [(50_000, 512), (4096, 256), (300, 256)])
def test_select_topk_scored_matches_numpy_sort(n, k):
    """Top-k of a sparse scored grid == a numpy sort of its codes, with
    zero padding once the survivors run out."""
    shapes = {50_000: (200, 250), 4096: (64, 64), 300: (12, 25)}
    h, w = shapes[n]
    rng = np.random.default_rng(5)
    scored = np.zeros(n, np.uint8)
    nz = rng.choice(n, min(n // 2, 1500), replace=False)
    scored[nz] = rng.integers(1, 256, len(nz))
    scored = scored.reshape(h, w)
    codes, valid = nms.select_topk_scored(jnp.asarray(scored), k)
    ys, xs = np.nonzero(scored)
    enc = ((scored[ys, xs].astype(np.uint64) << 24) | (xs.astype(np.uint64)
           << 12) | ys.astype(np.uint64)).astype(np.uint32)
    want = np.zeros(k, np.uint32)
    top = np.sort(enc)[::-1][:k]
    want[:len(top)] = top
    assert np.array_equal(np.asarray(codes), want)
    assert np.array_equal(np.asarray(valid), want != 0)


@pytest.mark.parametrize("k", [300, 2048])
def test_orb_compute_packed_matches_components(k):
    """The fused one-matmul ORB tail == moments, then atan2 bins, then the
    descriptor for each keypoint's own rotation."""
    rng = np.random.default_rng(7)
    flat = jnp.asarray(rng.integers(-128, 128, (k, 1024)).astype(np.int8))
    ang, desc = brief.orb_compute_packed(flat, 8)
    m10, m01 = orientation.centroids_packed(flat)
    eang = orientation.atan2_bins(m10, m01)
    edesc = brief.describe_packed(flat, eang, 8)
    assert np.array_equal(np.asarray(ang), np.asarray(eang))
    assert np.array_equal(np.asarray(desc), np.asarray(edesc))
    assert len(np.unique(np.asarray(ang))) > 20  # many rotations exercised


def _numpy_match(d1, d2, v1, v2, max_distance=64, ratio=0.8, gate=None):
    """Brute force: popcount Hamming, first-occurrence argmins, Lowe ratio,
    mutual cross-check; `gate` = (uv1, uv2, radius) keeps pairs whose
    float32 squared distance is <= radius^2."""
    x = d1[:, None, :] ^ d2[None, :, :]
    dist = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.int64)
    dist[~v1] = matching.MAX_DIST
    dist[:, ~v2] = matching.MAX_DIST
    if gate is not None:
        uv1, uv2, r = gate
        with np.errstate(invalid="ignore"):
            diff = uv1[:, None, :] - uv2[None, :, :]
            d2sq = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
        dist[~(d2sq <= np.float32(r * r))] = matching.MAX_DIST
    best_idx = np.argmin(dist, axis=1)
    rows = np.arange(len(d1))
    best = dist[rows, best_idx]
    masked = dist.copy()
    masked[rows, best_idx] = matching.MAX_DIST
    second = masked.min(axis=1)
    ok = (best <= max_distance) & (best.astype(np.float32)
                                   < np.float32(ratio) * second.astype(
                                       np.float32))
    ok &= np.argmin(dist, axis=0)[best_idx] == rows
    ok &= v1
    return np.where(ok, best_idx, -1), np.where(ok, best, matching.MAX_DIST)


@pytest.mark.parametrize("gated", [False, True])
def test_matching_matches_numpy_brute_force(gated):
    rng = np.random.default_rng(21)
    k1, k2 = 320, 512
    d1 = rng.integers(0, 2**32, (k1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (k2, 8), dtype=np.uint32)
    for i in range(0, k1, 2):   # near-duplicates so ratio/cross-check bite
        d2[(i * 3) % k2] = d1[i] ^ np.uint32(rng.integers(0, 2**12))
    d2[100] = d2[101] = d1[7]   # exact tie: first occurrence wins ...
    d2[200] = d1[9]
    d2[300] = d1[9] ^ np.uint32(1)    # ... and a near tie for the ratio
    v1 = rng.random(k1) < 0.9
    v2 = rng.random(k2) < 0.9
    v1[[7, 9]] = True
    v2[[100, 101, 200, 300]] = True
    uv1 = rng.uniform(-0.5, 0.5, (k1, 2)).astype(np.float32)
    uv2 = rng.uniform(-0.5, 0.5, (k2, 2)).astype(np.float32)
    for i in range(0, k1, 2):
        uv2[(i * 3) % k2] = uv1[i] + rng.normal(0, 0.02, 2)
    radius = 0.0625             # exact in binary: r^2 = 2^-8
    uv2[40], uv2[41] = 1e6, np.inf    # behind-camera sentinels
    uv2[44] = [0.125, -0.25]
    uv1[44] = [0.1875, -0.25]   # exactly ON the radius: stays a candidate
    d2[44] = d1[44]
    v1[44] = v2[44] = True
    j = jnp.asarray
    if gated:
        idx, dist = matching.match_gated(j(d1), j(d2), j(v1), j(v2), j(uv1),
                                         j(uv2), radius)
        eidx, edist = _numpy_match(d1, d2, v1, v2,
                                   gate=(uv1, uv2, radius))
        assert eidx[44] == 44
    else:
        idx, dist = matching.match(j(d1), j(d2), j(v1), j(v2))
        eidx, edist = _numpy_match(d1, d2, v1, v2)
    assert (eidx >= 0).sum() > 50
    assert np.array_equal(np.asarray(idx), eidx)
    assert np.array_equal(np.asarray(dist), edist)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(env_set, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins where set; otherwise <repo>/.jax_cache,
    which git ignores."""
    from pislam_tpu.utils import cache

    saved_env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    saved_cfg = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
            want = str(tmp_path)
        else:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
            want = os.path.join(REPO, ".jax_cache")
        assert cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.environ["JAX_COMPILATION_CACHE_DIR"] == want
    finally:
        if saved_env is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = saved_env
        jax.config.update("jax_compilation_cache_dir", saved_cfg)
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored and "native/build/" in ignored


def _lowered_ba():
    from test_backend import synthetic_ba
    from pislam_tpu.backend import ba

    prob, _ = synthetic_ba(nc=3, npts=16, seed=1, pad_obs=16)
    return jax.jit(lambda p: ba.ba_iterations(p, 2, 1e-3)).lower(prob)


def _lowered_pnp():
    from pislam_tpu.backend import pnp

    n = 32
    args = (jnp.eye(3), jnp.zeros(3), jnp.ones((n, 3)), jnp.zeros((n, 2)),
            jnp.ones(n, bool))
    return jax.jit(pnp.motion_only_ba).lower(*args)


def _lowered_ransac():
    from pislam_tpu.geometry import ransac

    n = 64
    return ransac.ransac_essential.lower(
        jax.random.PRNGKey(0), jnp.zeros((n, 2)), jnp.zeros((n, 2)),
        jnp.ones(n, bool), iters=16)


@pytest.mark.parametrize("lower", [_lowered_ba, _lowered_pnp,
                                   _lowered_ransac])
def test_float_products_request_highest_precision(lower):
    """Every float32 product of BA, PnP and essential RANSAC carries
    precision HIGHEST (set once, at package import), so a GPU runs them in
    full float32 and not TF32."""
    dots = [ln for ln in lower().as_text().splitlines()
            if "dot_general" in ln and "f32>" in ln]
    assert dots, "no float32 products found"
    for ln in dots:
        assert "precision = [HIGHEST, HIGHEST]" in ln, ln


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py must exit non-zero and print no result without a GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr
