"""Windowed sparse bundle adjustment with Schur-complement reduction.

No reference counterpart (the reference is the SLAM *frontend* only,
README.md:22); specified by BASELINE.json north star: "sparse bundle
adjustment with Schur-complement reduction ... BA reductions over
collectives". Design decisions (SURVEY.md section 7, hard part (d)):

* Fixed-shape block sparsity: a BA window holds C poses, P landmark slots and
  O observation slots, each with validity masks. Invalid slots carry zero
  Jacobians and drop out of every sum.
* The camera-point coupling W is stored DENSE per point -- (P, C*6, 3) -- which
  is tiny for windowed BA (C<=16) and turns the Schur complement into one
  einsum instead of sparse scatter-gathers:
      S = H_cc + lambda I - sum_p W_p Hpp_p^{-1} W_p^T
* Landmark blocks H_pp are (P, 3, 3); their inverses are closed-form adjugate
  (batched, no linalg loop).
* Gauss-Newton/LM runs a fixed number of iterations (lax.scan) with
  accept/reject damping updates expressed as jnp.where -- no data-dependent
  control flow.

Camera model: normalised pinhole. A world point X observed by pose (R, t)
projects to pi(R X + t), pi(x, y, z) = (x/z, y/z); residual = pi - uv.
Pose updates are left-multiplicative twists: pose <- exp(delta) o pose.
Gauge freedom: camera 0 is held fixed.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3


class BAProblem(NamedTuple):
    """One BA window (all arrays fixed-shape, masked)."""
    R: jax.Array          # (C, 3, 3) world->cam rotations
    t: jax.Array          # (C, 3)
    points: jax.Array     # (P, 3) world landmarks
    obs_cam: jax.Array    # (O,) int32 camera index per observation
    obs_pt: jax.Array     # (O,) int32 landmark index
    obs_uv: jax.Array     # (O, 2) normalised measurements
    obs_valid: jax.Array  # (O,) bool
    cam_valid: jax.Array  # (C,) bool
    pt_valid: jax.Array   # (P,) bool


def _project(R, t, X):
    xc = (R @ X[..., None])[..., 0] + t
    z = jnp.maximum(xc[..., 2], 1e-6)
    return xc[..., :2] / z[..., None], xc


def residuals_and_jacobians(p: BAProblem, huber: float = 0.0):
    """Per-observation residual (O, 2), J_c (O, 2, 6), J_p (O, 2, 3).

    J_c is wrt a left-multiplicative twist [rho, w] on (R, t):
        d(xc)/d rho = I,  d(xc)/d w = -[xc]_x
    and J_p is wrt the world point: d(xc)/dX = R.
    Projection jacobian: d(pi)/d(xc) = [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]].

    With ``huber`` > 0 the rows are additionally scaled by sqrt of the
    Huber IRLS weight min(1, huber/|r|) (the ORB-SLAM robust kernel):
    the normal equations become Huber-robust and the summed squared
    residual becomes the (within-quadratic-regime) robust cost. Without
    it one gross outlier (a bad association surviving to BA; measured
    |r| up to 25.8 in NORMALISED coords on eval_seq2 post-closure)
    dominates the objective so completely that every LM step is
    rejected and global BA silently no-ops. The 4th return stays the
    plain 0/1 validity mask.
    """
    R = p.R[p.obs_cam]
    t = p.t[p.obs_cam]
    X = p.points[p.obs_pt]
    uv, xc = _project(R, t, X)
    r = uv - p.obs_uv

    x, y, z = xc[..., 0], xc[..., 1], jnp.maximum(xc[..., 2], 1e-6)
    zinv = 1.0 / z
    zero = jnp.zeros_like(zinv)
    # (O, 2, 3) projection jacobian
    jpi = jnp.stack([
        jnp.stack([zinv, zero, -x * zinv * zinv], -1),
        jnp.stack([zero, zinv, -y * zinv * zinv], -1),
    ], -2)

    dxc_dw = -se3.hat(xc)                       # (O, 3, 3)
    jc = jnp.concatenate([jpi, jpi @ dxc_dw], -1)  # (O, 2, 6): [d/drho, d/dw]
    jp = jpi @ R                                # (O, 2, 3)

    w = (p.obs_valid
         & p.cam_valid[p.obs_cam]
         & p.pt_valid[p.obs_pt]).astype(r.dtype)
    s = w
    if huber > 0:
        rn = jnp.linalg.norm(r, axis=1)
        s = w * jnp.sqrt(jnp.where(rn > huber,
                                   huber / jnp.maximum(rn, 1e-12), 1.0))
    return r * s[:, None], jc * s[:, None, None], jp * s[:, None, None], w


def _adjugate_inv3(m, damping):
    """Batched closed-form inverse of (…,3,3) SPD blocks with LM damping."""
    m = m + damping * jnp.eye(3, dtype=m.dtype)
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    adj = jnp.stack([
        jnp.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
        jnp.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
        jnp.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
    ], -2)
    return adj / det[..., None, None]


def gn_normal_blocks(p: BAProblem, r, jc, jp):
    """Assemble the Schur ingredients from per-observation terms.

    Returns (H_cc (C,6,6), b_c (C,6), H_pp (P,3,3), b_p (P,3),
    W (P, C, 6, 3)). All via segment_sum (a fixed-shape scatter-add).
    """
    C = p.R.shape[0]
    P = p.points.shape[0]

    hcc = jax.ops.segment_sum(
        jnp.einsum("oki,okj->oij", jc, jc), p.obs_cam, num_segments=C)
    bc = jax.ops.segment_sum(
        -jnp.einsum("oki,ok->oi", jc, r), p.obs_cam, num_segments=C)
    hpp = jax.ops.segment_sum(
        jnp.einsum("oki,okj->oij", jp, jp), p.obs_pt, num_segments=P)
    bp = jax.ops.segment_sum(
        -jnp.einsum("oki,ok->oi", jp, r), p.obs_pt, num_segments=P)
    # W indexed by (point, camera): flatten pair index for one segment_sum
    wobs = jnp.einsum("oki,okj->oij", jc, jp)  # (O, 6, 3)
    pair = p.obs_pt * C + p.obs_cam
    w = jax.ops.segment_sum(wobs, pair, num_segments=P * C)
    return hcc, bc, hpp, bp, w.reshape(P, C, 6, 3)


def schur_reduce(hcc, bc, hpp, bp, w, damping, cam_valid, axis_name=None,
                 n_fixed: int = 1, anchor=None):
    """Form the reduced camera system (S, b) and the point-solve helper.

    S = blockdiag(H_cc) + lambda I - sum_p Wp Hpp^{-1} Wp^T   ((6C, 6C) dense)
    b = b_c - sum_p Wp Hpp^{-1} b_p

    With `axis_name`, landmark shards are reduced over the mesh axis with
    psum (hcc/bc are also partial sums over the local observation shard):
    this IS the distributed Schur-complement reduction over collectives
    (BASELINE.json north star). The returned (hpp_inv, wf) stay local to the
    shard for back-substitution. ``anchor`` (6C,), a unit vector, pins one
    more direction of the camera update (see scale_anchor).
    """
    C = hcc.shape[0]
    P = hpp.shape[0]
    hpp_inv = _adjugate_inv3(hpp, damping)          # (P, 3, 3) local
    wf = w.reshape(P, C * 6, 3)                     # camera-major block rows
    whi = jnp.einsum("pij,pjk->pik", wf, hpp_inv)   # (P, 6C, 3)
    cross = jnp.einsum("pik,plk->il", whi, wf)      # (6C, 6C) local partial
    bcross = jnp.einsum("pik,pk->pi", whi, bp).sum(0).reshape(-1)
    if axis_name is not None:
        hcc = jax.lax.psum(hcc, axis_name)
        bc = jax.lax.psum(bc, axis_name)
        cross = jax.lax.psum(cross, axis_name)
        bcross = jax.lax.psum(bcross, axis_name)
    idx = jnp.arange(C)
    s = (-cross).reshape(C, 6, C, 6).at[idx, :, idx, :].add(hcc)
    s = s.reshape(6 * C, 6 * C) + damping * jnp.eye(6 * C, dtype=cross.dtype)
    b = bc.reshape(-1) - bcross
    if anchor is not None:
        # S <- P S P + a a^T, b <- P b with P = I - a a^T: the solve leaves
        # the update's component along `anchor` at zero
        sa = s @ anchor
        s = (s - jnp.outer(anchor, sa) - jnp.outer(sa, anchor)
             + (anchor @ sa + 1.0) * jnp.outer(anchor, anchor))
        b = b - (anchor @ b) * anchor

    # gauge + invalid cameras: pin their deltas to zero via identity rows.
    # n_fixed >= 2 additionally anchors the SCALE gauge: monocular BA with
    # one pinned camera leaves the window scale free, and the Huber kernel
    # makes scale drift cheap enough to collapse a weakly-linked sub-map's
    # baseline (measured on eval_seq2: the bootstrap keyframe pair
    # collapsed from |c1-c0| = 1.0 to 0.004 map units). Holding the two
    # oldest cameras pins the first baseline -- the fixed-keyframes idea
    # of ORB-SLAM's local BA, minimally.
    pin = jnp.repeat(~cam_valid | (jnp.arange(C) < n_fixed), 6)
    s = jnp.where(pin[:, None] | pin[None, :],
                  jnp.eye(6 * C, dtype=s.dtype), s)
    b = jnp.where(pin, 0.0, b)
    return s, b, hpp_inv, wf


def _pcg(apply, minv_apply, b, iters: int):
    """Fixed-iteration preconditioned conjugate gradient (flat pytree x).

    `apply`/`minv_apply` are linear operators on arrays shaped like `b`.
    Runs exactly `iters` iterations inside a lax.scan (no data-dependent
    exit -- XLA-friendly); guards against zero curvature/residual so
    converged systems stay put instead of producing NaNs.
    """
    x = jnp.zeros_like(b)
    r = b
    z = minv_apply(r)
    pvec = z
    rz = jnp.vdot(r, z)

    def step(carry, _):
        x, r, pvec, rz = carry
        ap = apply(pvec)
        denom = jnp.vdot(pvec, ap)
        alpha = jnp.where(jnp.abs(denom) > 1e-30, rz / denom, 0.0)
        x = x + alpha * pvec
        r = r - alpha * ap
        z = minv_apply(r)
        rz_new = jnp.vdot(r, z)
        beta = jnp.where(jnp.abs(rz) > 1e-30, rz_new / rz, 0.0)
        pvec = z + beta * pvec
        return (x, r, pvec, rz_new), None

    (x, _, _, _), _ = jax.lax.scan(step, (x, r, pvec, rz), None, length=iters)
    return x


def reduced_system_cg(p: BAProblem, r, jc, jp, damping, iters: int,
                      axis_name=None, n_fixed: int = 1, anchor=None):
    """Solve the Schur-reduced camera system matrix-free with block-Jacobi
    preconditioned CG -- the large-window path.

    The dense path (schur_reduce) materialises W as (P, C*6, 3) and S as
    (6C, 6C): O(P C) memory and O((6C)^3) solve, fine for windowed BA
    (C <= 16) but a ceiling for global BA at keyframe_capacity 256+.
    Here S x is applied from per-OBSERVATION terms only:

        S x = (H_cc + lambda I) x - sum_o J_c^T J_p Hpp^{-1} [sum_o' J_p^T J_c x]

    i.e. two segment_sums per CG iteration, O(O) memory, never forming W
    or S. Preconditioner: per-camera 6x6 blocks of (H_cc + lambda I),
    inverted once per LM iteration. With `axis_name`, observation/landmark
    shards psum the camera-sized vectors (the same distributed Schur
    reduction as the dense path, but per CG iteration).

    Returns (dc_flat (6C,), hpp_inv, bp) -- the latter two for landmark
    back-substitution (shard-local, exactly as the dense path).
    """
    C = p.R.shape[0]
    P = p.points.shape[0]

    def allsum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    hcc = jax.ops.segment_sum(
        jnp.einsum("oki,okj->oij", jc, jc), p.obs_cam, num_segments=C)
    bc = jax.ops.segment_sum(
        -jnp.einsum("oki,ok->oi", jc, r), p.obs_cam, num_segments=C)
    hpp = jax.ops.segment_sum(
        jnp.einsum("oki,okj->oij", jp, jp), p.obs_pt, num_segments=P)
    bp = jax.ops.segment_sum(
        -jnp.einsum("oki,ok->oi", jp, r), p.obs_pt, num_segments=P)
    hcc = allsum(hcc)
    bc = allsum(bc)
    hpp_inv = _adjugate_inv3(hpp, damping)  # (P, 3, 3) shard-local

    # gauge + invalid cameras; n_fixed >= 2 also anchors the scale gauge
    # (see schur_reduce)
    pin = ~p.cam_valid | (jnp.arange(C) < n_fixed)

    def cams_from_points(z):
        """(P, 3) landmark-space vector -> (C, 6) camera accumulation."""
        w = jnp.einsum("oki,oi->ok", jp, z[p.obs_pt])     # (O, 2)
        c = jnp.einsum("oki,ok->oi", jc, w)               # (O, 6)
        return allsum(jax.ops.segment_sum(c, p.obs_cam, num_segments=C))

    def points_from_cams(x):
        """(C, 6) camera vector -> (P, 3) landmark accumulation W^T x."""
        u = jnp.einsum("oki,oi->ok", jc, x[p.obs_cam])    # (O, 2)
        v = jnp.einsum("oki,ok->oi", jp, u)               # (O, 3)
        return jax.ops.segment_sum(v, p.obs_pt, num_segments=P)

    def project(v_flat):
        # P = I - a a^T (see schur_reduce's anchor)
        if anchor is None:
            return v_flat
        return v_flat - (anchor @ v_flat) * anchor

    def apply(x_flat):
        x = jnp.where(pin[:, None], 0.0,
                      project(x_flat).reshape(C, 6))
        y = points_from_cams(x)                           # (P, 3) local
        z = jnp.einsum("pij,pj->pi", hpp_inv, y)
        out = (jnp.einsum("cij,cj->ci", hcc, x) + damping * x
               - cams_from_points(z)).reshape(-1)
        if anchor is not None:
            out = project(out) + (anchor @ x_flat) * anchor
        out = jnp.where(pin[:, None], x_flat.reshape(C, 6),
                        out.reshape(C, 6))
        return out.reshape(-1)

    # block-Jacobi preconditioner from (H_cc + lambda I) camera blocks
    blocks = hcc + damping * jnp.eye(6, dtype=hcc.dtype)
    blocks = jnp.where(pin[:, None, None], jnp.eye(6, dtype=hcc.dtype),
                       blocks)
    binv = jnp.linalg.inv(blocks)                         # (C, 6, 6)

    def minv(r_flat):
        return jnp.einsum("cij,cj->ci", binv,
                          r_flat.reshape(C, 6)).reshape(-1)

    z0 = jnp.einsum("pij,pj->pi", hpp_inv, bp)
    b = bc - cams_from_points(z0)
    b = jnp.where(pin[:, None], 0.0, b).reshape(-1)
    dc_flat = _pcg(apply, minv, project(b), iters)
    return dc_flat, hpp_inv, bp, points_from_cams


def ba_cost(p: BAProblem, huber: float = 0.0):
    r, _, _, w = residuals_and_jacobians(p, huber=huber)
    return jnp.sum(r * r), jnp.sum(w)


def _apply_update(p: BAProblem, dc, dp, pt_valid):
    dR, dt = se3.se3_exp(dc)
    Rn = dR @ p.R
    tn = (dR @ p.t[..., None])[..., 0] + dt
    Xn = p.points + dp * pt_valid[:, None]
    return p._replace(R=Rn, t=tn, points=Xn)


def _scale_anchor(p: BAProblem, k: int):
    """(6C,) unit vector: camera k's centre moving along the baseline from
    camera 0. With the left twist [rho, w] the centre c = -R^T t moves by
    dc = -R^T rho, so d|c_k - c_0| = -(R_k u) . rho_k, u the unit
    baseline."""
    c = -jnp.einsum("cji,cj->ci", p.R, p.t)
    u = c[k] - c[0]
    u = u / jnp.maximum(jnp.linalg.norm(u), 1e-12)
    a = jnp.zeros((p.R.shape[0], 6), p.R.dtype).at[k, :3].set(p.R[k] @ u)
    return a.reshape(-1)


def ba_iterations(p: BAProblem, iters: int, damping: float, axis_name=None,
                  solver: str = "dense", cg_iters: int = 64,
                  huber: float = 0.0, n_fixed: int = 1,
                  scale_anchor: bool = False):
    """LM iteration loop, optionally distributed over `axis_name` (landmark/
    observation shards; poses replicated). Pure function, jit/shard_map-safe.

    solver="dense" factorises the (6C, 6C) reduced camera matrix
    (schur_reduce); "cg" solves it matrix-free from per-observation terms
    (reduced_system_cg) -- same answers within CG tolerance, O(O) memory,
    the path for global BA at large keyframe capacity. ``huber`` > 0
    enables the robust kernel (residuals_and_jacobians); both the normal
    equations and the accept/reject costs use the robustified residuals,
    so a gross outlier cannot veto every LM step.

    ``scale_anchor`` fixes the monocular gauge with exactly seven degrees
    of freedom: the first ``n_fixed`` cameras are pinned, and camera
    ``n_fixed`` keeps only its distance to camera 0 (its rotation and the
    two other directions of its centre stay free). Pinning two whole
    cameras instead fixes twelve, and the five extra hold the second
    camera's tracked error in place."""
    assert solver in ("dense", "cg")

    def allsum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    def step(carry, _):
        prob, lam = carry
        r, jc, jp, wmask = residuals_and_jacobians(prob, huber=huber)
        cost0 = allsum(jnp.sum(r * r))
        anchor = _scale_anchor(prob, n_fixed) if scale_anchor else None
        if solver == "cg":
            dc_flat, hpp_inv, bp, points_from_cams = reduced_system_cg(
                prob, r, jc, jp, lam, cg_iters, axis_name=axis_name,
                n_fixed=n_fixed, anchor=anchor)
            dc = dc_flat.reshape(-1, 6)
            dp = jnp.einsum("pij,pj->pi", hpp_inv,
                            bp - points_from_cams(dc))
        else:
            hcc, bc, hpp, bp, w = gn_normal_blocks(prob, r, jc, jp)
            s, b, hpp_inv, wf = schur_reduce(
                hcc, bc, hpp, bp, w, lam, prob.cam_valid,
                axis_name=axis_name, n_fixed=n_fixed, anchor=anchor)
            dc_flat = jnp.linalg.solve(s, b)
            dc = dc_flat.reshape(-1, 6)
            # back-substitute landmarks: dp = Hpp^{-1} (b_p - W^T dc), local
            dp = jnp.einsum("pij,pj->pi", hpp_inv,
                            bp - jnp.einsum("pik,i->pk", wf, dc_flat))
        cand = _apply_update(prob, dc, dp, prob.pt_valid)
        r1, _, _, _ = residuals_and_jacobians(cand, huber=huber)
        cost1 = allsum(jnp.sum(r1 * r1))
        accept = cost1 < cost0
        new_prob = jax.tree.map(
            lambda a, bb: jnp.where(accept, a, bb), cand, prob)
        new_lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7),
                            jnp.minimum(lam * 4.0, 1e3))
        return (new_prob, new_lam), jnp.where(accept, cost1, cost0)

    (prob, lam), costs = jax.lax.scan(
        step, (p, jnp.asarray(damping, p.points.dtype)), None, length=iters)
    return prob, {"costs": costs, "final_damping": lam}


@partial(jax.jit, static_argnames=("iters", "solver", "cg_iters", "huber",
                                   "n_fixed", "scale_anchor"))
def bundle_adjust(p: BAProblem, iters: int = 8, damping: float = 1e-4,
                  solver: str = "auto", cg_iters: int = 64,
                  huber: float = 0.0, n_fixed: int = 1,
                  scale_anchor: bool = False):
    """Run `iters` LM iterations single-device. Returns (problem, info).

    solver="auto" picks the dense Schur factorisation for windowed sizes
    and matrix-free CG above 48 cameras (where the dense path's (P, C*6, 3)
    W tensor and O((6C)^3) factorisation stop scaling)."""
    if solver == "auto":
        solver = "cg" if p.R.shape[0] > 48 else "dense"
    return ba_iterations(p, iters, damping, solver=solver, cg_iters=cg_iters,
                         huber=huber, n_fixed=n_fixed,
                         scale_anchor=scale_anchor)
