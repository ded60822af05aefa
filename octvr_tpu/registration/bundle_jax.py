"""JAX bundle adjustment: analytic per-match Jacobian blocks, camera-block
normal-equation assembly, and the full LM loop inside ONE jitted program.

The NumPy path (bundle.py) mirrors the reference's numeric-difference
CvLevMarq in f64 for parity (motion_estimators.cpp:176-277, numeric
Jacobian :579-601).  This path is the scale-out design from SURVEY.md §7:

* residuals are pure jnp; each match's Jacobian wrt its TWO cameras'
  4-param blocks comes from ``jax.jacfwd`` vmapped over matches —
  O(m) block work instead of the dense [3m, 4n] Jacobian (rotation-only
  pano BA has no landmarks, so the camera blocks ARE the reduced system;
  the [4n, 4n] normal matrix is assembled by scatter-adding 4x4 blocks);
* the LM damping loop (solve, trial step, accept/reject, lambda update)
  runs inside jit as a ``lax.while_loop`` — one host round-trip per
  *phase*, not per iteration;
* with a mesh, the match axis shards over devices and the tiny [4n, 4n]
  / [4n] reductions psum across devices (jax.shard_map).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .bundle import BundleData, inv_rodrigues, rodrigues

__all__ = ["bundle_adjust_ray_jax"]

# every product here runs at HIGHEST precision: the residuals are
# unit-ray differences of ~1e-3 rad (a pixel at f ~ 1000), so TF32's
# ~1e-3 relative rounding would be the size of the signal, and the
# result is held to |drms| < 1e-3 against the float64 NumPy adjuster
_HI = jax.lax.Precision.HIGHEST


def _rodrigues_jnp(rvec):
    theta = jnp.sqrt(jnp.sum(rvec * rvec) + 1e-12)
    k = rvec / theta
    kx, ky, kz = k[0], k[1], k[2]
    K = jnp.array([[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]])
    return (
        jnp.eye(3) + jnp.sin(theta) * K + (1.0 - jnp.cos(theta)) * jnp.matmul(K, K, precision=_HI)
    )


def _pair_residual(pi, pj, pt1, pt2, sz1, sz2):
    """One match: 4-param camera blocks (f, rvec) x2 -> residual [3]
    (unit-ray difference scaled by sqrt(f_i f_j),
    motion_estimators.cpp:505-578)."""

    def ray(p, pt, sz):
        f = p[0]
        R = _rodrigues_jnp(p[1:4])
        v = jnp.array(
            [(pt[0] - sz[0] * 0.5) / f, (pt[1] - sz[1] * 0.5) / f, 1.0]
        )
        w = jnp.matmul(R, v, precision=_HI)
        return w / jnp.linalg.norm(w)

    r = ray(pi, pt1, sz1) - ray(pj, pt2, sz2)
    return r * jnp.sqrt(jnp.abs(pi[0] * pj[0]))


# residual + the two 4-param Jacobian blocks, vmapped over matches
_pair_jac = jax.jacfwd(_pair_residual, argnums=(0, 1))
_v_res = jax.vmap(_pair_residual, in_axes=(0, 0, 0, 0, 0, 0))
_v_jac = jax.vmap(_pair_jac, in_axes=(0, 0, 0, 0, 0, 0))


def _norm_eqs(x, cam_i, cam_j, p1, p2, sizes, n, axis=None):
    """Camera-block JtJ [4n,4n], Jtr [4n], cost — scatter-added 4x4
    blocks, psum'd over ``axis`` when match-sharded."""
    P = x.reshape(n, 4)
    pi, pj = P[cam_i], P[cam_j]
    s1, s2 = sizes[cam_i], sizes[cam_j]
    r = _v_res(pi, pj, p1, p2, s1, s2)  # [m, 3]
    Ji, Jj = _v_jac(pi, pj, p1, p2, s1, s2)  # [m, 3, 4] x2

    def blk(a, b):  # [m, 4, 4]
        return jnp.einsum("mri,mrj->mij", a, b, precision=_HI)

    JtJ = jnp.zeros((n, 4, n, 4))
    JtJ = JtJ.at[cam_i, :, cam_i, :].add(blk(Ji, Ji))
    JtJ = JtJ.at[cam_j, :, cam_j, :].add(blk(Jj, Jj))
    JtJ = JtJ.at[cam_i, :, cam_j, :].add(blk(Ji, Jj))
    JtJ = JtJ.at[cam_j, :, cam_i, :].add(blk(Jj, Ji))
    Jtr = jnp.zeros((n, 4))
    Jtr = Jtr.at[cam_i].add(jnp.einsum("mri,mr->mi", Ji, r, precision=_HI))
    Jtr = Jtr.at[cam_j].add(jnp.einsum("mri,mr->mi", Jj, r, precision=_HI))
    cost = jnp.sum(r * r)
    JtJ = JtJ.reshape(4 * n, 4 * n)
    Jtr = Jtr.reshape(4 * n)
    if axis is not None:
        JtJ = jax.lax.psum(JtJ, axis)
        Jtr = jax.lax.psum(Jtr, axis)
        cost = jax.lax.psum(cost, axis)
    return JtJ, Jtr, cost


def _cost_only(x, cam_i, cam_j, p1, p2, sizes, n, axis=None):
    P = x.reshape(n, 4)
    r = _v_res(P[cam_i], P[cam_j], p1, p2, sizes[cam_i], sizes[cam_j])
    c = jnp.sum(r * r)
    return jax.lax.psum(c, axis) if axis is not None else c


def _lm_body(n, max_iter, axis=None):
    """The full LM loop as one traced program (no host round-trips)."""

    def run(x0, free, cam_i, cam_j, p1, p2, sizes):
        args = (cam_i, cam_j, p1, p2, sizes)
        cost0 = _cost_only(x0, *args, n, axis)

        def cond(st):
            x, lam, cost, it, stall = st
            return (it < max_iter) & (stall < 8) & (lam < 1e12)

        def body(st):
            x, lam, cost, it, stall = st
            JtJ, Jtr, _ = _norm_eqs(x, *args, n, axis)
            # lock params outside the free set: unit diagonal, zero
            # gradient (the two-phase schedule locks focals first)
            fm = free.astype(JtJ.dtype)
            A = JtJ * fm[:, None] * fm[None, :] + jnp.diag(1.0 - fm)
            g = Jtr * fm
            damped = A + lam * jnp.diag(jnp.diag(A) + 1e-9)
            delta = jnp.linalg.solve(damped, -g)
            xn = x + delta * fm
            cn = _cost_only(xn, *args, n, axis)
            accept = cn < cost
            x = jnp.where(accept, xn, x)
            cost = jnp.where(accept, cn, cost)
            lam = jnp.where(
                accept, jnp.maximum(lam * 0.1, 1e-10), lam * 10.0
            )
            stall = jnp.where(accept, 0, stall + 1)
            return (x, lam, cost, it + 1, stall)

        st = (x0, jnp.asarray(1e-3), cost0, jnp.asarray(0), jnp.asarray(0))
        x, lam, cost, it, _ = jax.lax.while_loop(cond, body, st)
        return x, cost

    return run


def bundle_adjust_ray_jax(
    features, matches, cameras, conf_thresh=1.0, max_iter=60, mesh=None
):
    """Drop-in alternative to bundle_adjust_ray: analytic camera-block
    LM fully on device (2 host round-trips total — one per phase); pass
    a Mesh to shard the correspondence reduction over devices."""
    n = len(cameras)
    data = BundleData.from_matches(features, matches, conf_thresh)
    m = len(data.cam_i)
    if m == 0:
        return cameras, float("nan")

    pad = m
    if mesh is not None:
        dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        pad = -(-m // dev) * dev
    cam_i = np.zeros(pad, np.int32)
    cam_j = np.zeros(pad, np.int32)
    p1 = np.zeros((pad, 2), np.float32)
    p2 = np.zeros((pad, 2), np.float32)
    cam_i[:m] = data.cam_i
    cam_j[:m] = data.cam_j
    p1[:m] = data.p1
    p2[:m] = data.p2
    # padding rows: both ends the same camera and pixel -> residual and
    # both Jacobian blocks are exactly zero, contributing nothing
    if pad > m:
        cam_j[m:] = cam_i[m:]
        p2[m:] = p1[m:]
    sizes = jnp.asarray(data.sizes, dtype=jnp.float32)

    if mesh is None:
        run = jax.jit(_lm_body(n, max_iter))
    else:
        from jax.sharding import PartitionSpec as P

        axis = mesh.axis_names[0]
        run = jax.jit(
            partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis), P()),
                out_specs=(P(), P()),
                check_vma=False,
            )(_lm_body(n, max_iter, axis))
        )

    x = np.zeros(n * 4, dtype=np.float32)
    for c, cam in enumerate(cameras):
        x[c * 4] = cam.focal
        x[c * 4 + 1 : c * 4 + 4] = inv_rodrigues(cam.R)

    # phase 1 locks focals (see bundle.py on the ray-cost collapse)
    free_masks = [np.ones(n * 4, bool), np.ones(n * 4, bool)]
    free_masks[0][0::4] = False

    args = (
        jnp.asarray(cam_i),
        jnp.asarray(cam_j),
        jnp.asarray(p1),
        jnp.asarray(p2),
        sizes,
    )
    cost = None
    for free in free_masks:
        xj, cj = run(jnp.asarray(x), jnp.asarray(free), *args)
        x = np.asarray(xj, dtype=np.float64)
        cost = float(cj)

    for c, cam in enumerate(cameras):
        cam.focal = float(x[c * 4])
        cam.R = rodrigues(x[c * 4 + 1 : c * 4 + 4])
    from .bundle import _center_normalize

    _center_normalize(cameras, matches, n)
    return cameras, float(np.sqrt(cost / m))
