"""Homography estimation + decomposition: the planar-scene initialiser.

An essential matrix is degenerate when the scene is a single plane (the
8-point system drops rank and RANSAC returns an arbitrary member of a
two-parameter family); real initialisers (ORB-SLAM) therefore also fit a
homography and recover (R, t, n) from it. Fixed-shape form: fixed-iteration
vmapped 4-point DLT hypotheses, one (iters, N) symmetric-transfer scoring
pass, Faugeras-Lustman decomposition into the 8 (R, t, n) candidates as a
fixed-shape batch, and cheirality (positive triangulated depths both views
+ plane-in-front) as a batched argmax -- no data-dependent control flow.

The reference ships no geometry at all (frontend-only, README.md:22).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import epipolar


def homography_dlt(p1, p2, weights=None):
    """(N, 2), (N, 2) normalised correspondences -> H (3, 3), p2 ~ H p1.

    Standard DLT: each correspondence gives two rows of the 2N x 9 system;
    H is the smallest right singular vector. `weights` (N,) optionally
    weights rows (used for the inlier refit)."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    r1 = jnp.stack([-x1, -y1, -o, z, z, z, x2 * x1, x2 * y1, x2], axis=1)
    r2 = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=1)
    if weights is not None:
        r1 = r1 * weights[:, None]
        r2 = r2 * weights[:, None]
    a = jnp.concatenate([r1, r2], axis=0)
    _u, _s, vt = jnp.linalg.svd(a, full_matrices=True)
    return vt[-1].reshape(3, 3)


def homography_dlt_fast(p1, p2):
    """(..., 4, 2) sample pairs -> batched UNNORMALISED H hypotheses.

    A 4-point sample gives an exactly-8-row DLT system: the nullvector
    comes from the shared LAPACK-free Householder QR
    (epipolar.nullvec_8x9) instead of a per-hypothesis SVD, as in the
    essential solver.
    Refit the winner with `homography_dlt` (exact SVD, once)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = jnp.zeros_like(x1)
    o = jnp.ones_like(x1)
    r1 = jnp.stack([-x1, -y1, -o, z, z, z, x2 * x1, x2 * y1, x2], axis=-1)
    r2 = jnp.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], axis=-1)
    a = jnp.concatenate([r1, r2], axis=-2)       # (..., 8, 9)
    q = epipolar.nullvec_8x9(a)
    return q.reshape(q.shape[:-1] + (3, 3))


def transfer_error(H, p1, p2):
    """(N,) symmetric transfer error of p2 ~ H p1 (both directions)."""
    def err(H, a, b):
        q = a @ H[:, :2].T + H[:, 2]
        w = jnp.where(jnp.abs(q[:, 2]) > 1e-9, q[:, 2], 1e-9)
        return jnp.sum((q[:, :2] / w[:, None] - b) ** 2, axis=1)

    Hi = jnp.linalg.inv(H + 1e-12 * jnp.eye(3))
    return err(H, p1, p2) + err(Hi, p2, p1)


def decompose_homography(H):
    """H (3, 3) -> 8 candidate (R (8,3,3), t (8,3), n (8,3)).

    Faugeras & Lustman (1988) via the SVD H = U diag(d1,d2,d3) V^T.
    Translations are up to scale (monocular); plane normals are in the
    FIRST camera's frame. The near-pure-rotation case (d1 ~ d3) collapses
    every candidate to (R = H/d2, t = 0)."""
    u, d, vt = jnp.linalg.svd(H)
    s = jnp.linalg.det(u) * jnp.linalg.det(vt)
    d1, d2, d3 = d[0] / d[1], 1.0, d[2] / d[1]

    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    x1 = jnp.sqrt(jnp.clip((d1 * d1 - 1.0) / denom, 0.0, None))
    x3 = jnp.sqrt(jnp.clip((1.0 - d3 * d3) / denom, 0.0, None))

    eps = jnp.array([(1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0)])

    def case_pos(e):  # d' = +d2
        e1, e3 = e
        st = (d1 - d3) * x1 * x3 * e1 * e3
        ct = d1 * x3 * x3 + d3 * x1 * x1
        Rp = jnp.array([[ct, 0.0, -st], [0.0, 1.0, 0.0], [st, 0.0, ct]])
        tp = (d1 - d3) * jnp.array([e1 * x1, 0.0, -e3 * x3])
        np_ = jnp.array([e1 * x1, 0.0, e3 * x3])
        return Rp, tp, np_

    def case_neg(e):  # d' = -d2
        e1, e3 = e
        sp = (d1 + d3) * x1 * x3 * e1 * e3
        cp = d3 * x1 * x1 - d1 * x3 * x3
        Rp = jnp.array([[cp, 0.0, sp], [0.0, -1.0, 0.0], [sp, 0.0, -cp]])
        tp = (d1 + d3) * jnp.array([e1 * x1, 0.0, e3 * x3])
        np_ = jnp.array([e1 * x1, 0.0, e3 * x3])
        return Rp, tp, np_

    Rp_a, tp_a, n_a = jax.vmap(case_pos)(eps)
    Rp_b, tp_b, n_b = jax.vmap(case_neg)(eps)
    Rp = jnp.concatenate([Rp_a, Rp_b])    # (8, 3, 3)
    tp = jnp.concatenate([tp_a, tp_b])    # (8, 3)
    nn = jnp.concatenate([n_a, n_b])      # (8, 3)

    R = s * jnp.einsum("ij,njk,kl->nil", u, Rp, vt)
    t = jnp.einsum("ij,nj->ni", u, tp)
    n = jnp.einsum("ji,nj->ni", vt, nn)   # V @ n'

    # near-pure rotation: d1 ~ d3 ~ 1 -> H/d2 is the rotation, t ~ 0
    pure = (d1 - d3) < 1e-4
    Rr = s * (u @ jnp.diag(jnp.sign(d / d[1])) @ vt)
    R = jnp.where(pure, jnp.broadcast_to(Rr, R.shape), R)
    t = jnp.where(pure, jnp.zeros_like(t), t)
    return R, t, n


def recover_pose_homography(H, p1, p2, weights):
    """Pick the (R, t, n) candidate with the best cheirality support.

    weights (N,): inlier weights. Support = correspondences that
    triangulate with positive depth in BOTH views AND lie in front of the
    candidate plane (n . p1_h > 0, ORB-SLAM's visibility check).

    Two views of a plane have a FUNDAMENTAL two-fold (R, t, n) ambiguity
    (both twins reproduce H exactly, epipolar constraint included), so the
    runner-up with a genuinely different rotation is returned alongside:
    (R, t, n, support, R2, t2, n2, support2). Callers should treat
    support2/support close to 1 as "ambiguous -- wait for more parallax
    or a third view" (the ORB-SLAM initialiser's rule)."""
    R, t, n = decompose_homography(H)
    p1h = jnp.concatenate([p1, jnp.ones((p1.shape[0], 1), p1.dtype)], 1)

    def unit(v):
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-9)

    # SVD sign freedom makes BOTH the t-sign and the n-sign (and their
    # relative pairing) backend-dependent conventions. Select on depth
    # cheirality alone, evaluated in each candidate's best t-orientation,
    # then orient n independently by the front-majority of the inliers.
    def support(Rk, tk, nk):
        tn = unit(tk)
        z1p, z2p = epipolar.triangulate_depths(Rk, tn, p1, p2)
        s_pos = jnp.sum(((z1p > 1e-6) & (z2p > 1e-6)) * weights)
        z1n, z2n = epipolar.triangulate_depths(Rk, -tn, p1, p2)
        s_neg = jnp.sum(((z1n > 1e-6) & (z2n > 1e-6)) * weights)
        t_sign = jnp.where(s_neg > s_pos, -1.0, 1.0)
        n_sign = jnp.where(jnp.sum(((p1h @ nk) > 0.0) * weights)
                           >= jnp.sum(((p1h @ nk) < 0.0) * weights),
                           1.0, -1.0)
        return jnp.maximum(s_pos, s_neg), t_sign, n_sign

    scores, t_signs, n_signs = jax.vmap(support)(R, t, n)
    k = jnp.argmax(scores)

    # runner-up among candidates with a DIFFERENT rotation (sign-mirrors
    # share R and are already folded into their candidate's orientation)
    same_R = jnp.sum((R - R[k]) ** 2, axis=(1, 2)) < 1e-6
    scores2 = jnp.where(same_R, -1.0, scores)
    k2 = jnp.argmax(scores2)
    return (R[k], t_signs[k] * unit(t[k]), n_signs[k] * n[k], scores[k],
            R[k2], t_signs[k2] * unit(t[k2]), n_signs[k2] * n[k2],
            jnp.maximum(scores2[k2], 0.0))


@partial(jax.jit, static_argnames=("iters",))
def select_model(key, p1, p2, valid, iters: int = 256,
                 e_threshold: float = 1.5e-3, h_threshold: float = 2e-3,
                 h_ratio: float = 0.45):
    """Two-view initialisation with E/H model selection (ORB-SLAM rule).

    Runs both the essential and the homography RANSAC on the same
    correspondences and picks the homography's pose when its inlier share
    S_H / (S_H + S_E) exceeds ``h_ratio`` (planar / low-parallax scene,
    where the essential solve is degenerate). Returns a dict with R, t
    (unit), inliers, num_inliers, used_homography (bool) and, when the
    homography wins, its planar two-fold twin (R2/t2/ambiguous).
    """
    from . import ransac as ransac_mod

    k1, k2 = jax.random.split(key)
    oe = ransac_mod.ransac_essential(
        k1, p1, p2, valid, iters=iters, inlier_threshold=e_threshold)
    oh = ransac_homography(
        k2, p1, p2, valid, iters=iters, inlier_threshold=h_threshold)
    s_e = oe["num_inliers"].astype(jnp.float32)
    s_h = oh["num_inliers"].astype(jnp.float32)
    use_h = s_h / jnp.maximum(s_h + s_e, 1.0) > h_ratio
    return {
        "R": jnp.where(use_h, oh["R"], oe["R"]),
        "t": jnp.where(use_h, oh["t"],
                       oe["t"] / jnp.maximum(
                           jnp.linalg.norm(oe["t"]), 1e-9)),
        "inliers": jnp.where(use_h, oh["inliers"], oe["inliers"]),
        "num_inliers": jnp.where(use_h, oh["num_inliers"],
                                 oe["num_inliers"]),
        "used_homography": use_h,
        "R2": oh["R2"],
        "t2": oh["t2"],
        "ambiguous": use_h & oh["ambiguous"],
    }


@partial(jax.jit, static_argnames=("iters", "sample_size"))
def ransac_homography(key, p1, p2, valid, iters: int = 256,
                      sample_size: int = 4, inlier_threshold: float = 2e-3):
    """Vmapped fixed-iteration homography RANSAC (ransac_essential shape).

    Returns dict with H, R, t (unit), n (plane normal, cam-1 frame),
    inliers, num_inliers. inlier_threshold is on sqrt(symmetric transfer
    error) in normalised units."""
    logits = jnp.where(valid, 0.0, -jnp.inf)
    idx = jax.random.categorical(
        key, logits[None, :], shape=(iters, sample_size))
    hs = homography_dlt_fast(p1[idx], p2[idx])           # (iters, 3, 3)
    err = jax.vmap(lambda h: transfer_error(h, p1, p2))(hs)
    thr2 = inlier_threshold * inlier_threshold
    inl = (err < thr2) & valid[None, :]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)

    w = inl[best].astype(p1.dtype)
    h_ref = homography_dlt(p1, p2, weights=w)
    err_ref = transfer_error(h_ref, p1, p2)
    inl_ref = (err_ref < thr2) & valid
    better = jnp.sum(inl_ref) >= scores[best]
    h_fin = jnp.where(better, h_ref, hs[best])
    inl_fin = jnp.where(better, inl_ref, inl[best])

    r, t, n, support, r2, t2, n2, support2 = recover_pose_homography(
        h_fin, p1, p2, inl_fin.astype(p1.dtype))
    return {
        "H": h_fin,
        "R": r,
        "t": t,
        "n": n,
        "inliers": inl_fin,
        "num_inliers": jnp.sum(inl_fin),
        "cheirality_support": support,
        # the planar two-fold twin: ambiguous when support2 ~ support
        "R2": r2,
        "t2": t2,
        "n2": n2,
        "cheirality_support2": support2,
        "ambiguous": support2 > 0.75 * support,
    }
