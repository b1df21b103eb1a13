"""Epipolar geometry: 8-point essential matrix, Sampson error, pose recovery.

No reference counterpart (frontend-only reference); this is the VO layer of
BASELINE.json configs[2]. Convention: normalised image points p = (u, v, 1)
(pixels pre-multiplied by K^-1); E = [t]x R with  p2^T E p1 = 0  and
X_cam2 = R X_cam1 + t.

Everything is fixed-shape and vmap-safe: the 8-point solve is an SVD of the
(N, 9) constraint matrix (works for N >= 8, weighted for refits), pose
recovery tests the 4 (R, t) candidates by closed-form two-view cheirality
counting (no per-point SVD).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp



def _constraint_rows(p1, p2, w=None):
    """(N, 2)+(N, 2) -> (N, 9) rows of the epipolar constraint p2h^T E p1h."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = jnp.ones_like(x1)
    rows = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], -1)
    if w is not None:
        rows = rows * w[..., None]
    return rows


def essential_8pt(p1, p2, weights=None):
    """Least-squares essential matrix from N >= 8 normalised correspondences.

    Solves min ||A e|| via SVD, then projects to the essential manifold
    (singular values (1, 1, 0)). Returns (3, 3) with unit Frobenius-ish scale.
    """
    a = _constraint_rows(p1, p2, weights)
    # e = right-singular vector of smallest singular value of A (9 columns)
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    e = vt[..., -1, :]
    em = e.reshape(e.shape[:-1] + (3, 3))
    u, _, vt2 = jnp.linalg.svd(em)
    # keep proper orientation for decomposability
    d = jnp.asarray([1.0, 1.0, 0.0], em.dtype)
    return u @ (d[..., :, None] * vt2)


def nullvec_8x9(a):
    """(..., 8, 9) -> (..., 9) unit nullvector, LAPACK-free.

    The nullvector of an exactly-8-row A is the 9th column of Q in the QR
    factorisation of A^T (9, 8), computed as 8 batched Householder
    reflections -- fixed-shape, unrolled, pure elementwise arithmetic,
    exact to f32 roundoff. It replaces a per-hypothesis batched SVD, which
    does not vectorise over hundreds of tiny matrices. Shared by the
    essential (8 x 1-row) and homography (4 x 2-row) RANSAC hypothesis
    solvers."""
    r = jnp.swapaxes(a, -1, -2)                  # (..., 9, 8) = A^T
    i9 = jnp.arange(9)
    vs = []
    for k in range(8):
        x = r[..., :, k]
        x = jnp.where(i9 >= k, x, 0.0)           # entries below the pivot
        xk = x[..., k]
        nrm = jnp.linalg.norm(x, axis=-1)
        alpha = -jnp.sign(jnp.where(xk == 0, 1.0, xk)) * nrm
        v = x - alpha[..., None] * (i9 == k)
        vn = jnp.linalg.norm(v, axis=-1, keepdims=True)
        # degenerate column (already triangular): identity reflection
        v = jnp.where(vn > 1e-20, v / jnp.maximum(vn, 1e-30), 0.0)
        r = r - 2.0 * v[..., :, None] * jnp.sum(
            v[..., :, None] * r, axis=-2, keepdims=True)
        vs.append(v)
    # nullvec = H1 ... H8 e9 (the 9th column of Q)
    q = (i9 == 8).astype(a.dtype) * jnp.ones_like(a[..., 0, :])
    for v in reversed(vs):
        q = q - 2.0 * v * jnp.sum(v * q, axis=-1, keepdims=True)
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True),
                           1e-30)


def essential_8pt_fast(p1, p2):
    """LAPACK-free batched 8-point hypotheses (see nullvec_8x9).

    Returns UNPROJECTED (3, 3) E estimates for Sampson scoring; refit the
    winning inlier set with `essential_8pt` (exact SVD + essential-
    manifold projection, once) before pose recovery."""
    q = nullvec_8x9(_constraint_rows(p1, p2))
    return q.reshape(q.shape[:-1] + (3, 3))


def sampson_error(E, p1, p2):
    """First-order geometric error of p2^T E p1 (squared, per point)."""
    p1h = jnp.concatenate([p1, jnp.ones_like(p1[..., :1])], -1)
    p2h = jnp.concatenate([p2, jnp.ones_like(p2[..., :1])], -1)
    Ep1 = p1h @ jnp.swapaxes(E, -1, -2)   # (N, 3) = (E @ p1h^T)^T
    Etp2 = p2h @ E                         # (N, 3) = (E^T @ p2h^T)^T
    num = jnp.sum(p2h * Ep1, -1) ** 2
    den = Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2 + Etp2[..., 0] ** 2 + Etp2[..., 1] ** 2
    return num / jnp.maximum(den, 1e-12)


def decompose_essential(E):
    """E -> (R_a, R_b, t): the two rotations and translation direction."""
    u, _, vt = jnp.linalg.svd(E)
    # enforce proper rotations
    u = u * jnp.sign(jnp.linalg.det(u))[..., None, None]
    vt = vt * jnp.sign(jnp.linalg.det(vt))[..., None, None]
    w = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    ra = u @ w @ vt
    rb = u @ w.T @ vt
    t = u[..., :, 2]
    return ra, rb, t


def triangulate_depths(R, t, p1, p2):
    """Closed-form two-view depths for cheirality testing.

    Rays d1 = (p1, 1) in cam1, d2 = (p2, 1) in cam2 with X2 = R X1 + t.
    Depth s along d1 minimises ||cross(d2, R (s d1) + t)||^2:
        s = -dot(cross(d2, R d1), cross(d2, t)) / ||cross(d2, R d1)||^2
    Returns (z1, z2): depths of the point in each camera.
    """
    d1 = jnp.concatenate([p1, jnp.ones_like(p1[..., :1])], -1)
    d2 = jnp.concatenate([p2, jnp.ones_like(p2[..., :1])], -1)
    rd1 = d1 @ jnp.swapaxes(R, -1, -2)
    c_rd1 = jnp.cross(d2, rd1)
    c_t = jnp.cross(d2, jnp.broadcast_to(t, d2.shape))
    s = -jnp.sum(c_rd1 * c_t, -1) / jnp.maximum(jnp.sum(c_rd1 * c_rd1, -1), 1e-12)
    x2 = s[..., None] * rd1 + t
    return s, x2[..., 2]


def recover_pose(E, p1, p2, weights):
    """Pick the (R, t) among the 4 decompositions with max cheirality support.

    weights: (N,) 0/1 inlier mask (float). Returns (R, t, support).
    """
    ra, rb, t = decompose_essential(E)
    best_r, best_t, best_n = None, None, None
    for R in (ra, rb):
        for tt in (t, -t):
            z1, z2 = triangulate_depths(R, tt, p1, p2)
            n = jnp.sum(weights * (z1 > 0) * (z2 > 0))
            if best_n is None:
                best_r, best_t, best_n = R, tt, n
            else:
                take = n > best_n
                best_r = jnp.where(take, R, best_r)
                best_t = jnp.where(take, tt, best_t)
                best_n = jnp.maximum(n, best_n)
    return best_r, best_t, best_n
