"""Exposure gain compensation (BL07 pairwise least squares).

Static-geometry redesign of the reference's GainCompensatorGPU
(stitching/src/exposure_compensate.cpp:174-313): pairwise mask
intersections and counts N(i,j) are precomputed at plan time from the
template masks at the 0.1 MP working scale; the per-frame work is one
luminance-norm per image, P masked sums, and a tiny dense solve — all
on-device inside the jitted stitch step (the reference round-trips the
sums to the host through shared pinned memory; here the solve is
cheap enough to stay on-device).
"""

from dataclasses import dataclass, field
from typing import List, Tuple

import jax.numpy as jnp
import numpy as np

from ..utils.pytree import register_plan

ALPHA = 0.01
BETA = 100.0

__all__ = ["GainPlan", "build_gain_plan", "solve_gains"]


@dataclass
class GainPlan:
    num_images: int
    N: tuple  # [n][n] int, static pair pixel counts (nested tuple)
    b: np.ndarray  # [n] f32, static rhs
    A_static: np.ndarray  # [n, n] f32, static part of the normal matrix
    # per pair (i, j), i<j with overlap: intersection masks restricted to
    # each image's working roi
    pairs: Tuple[Tuple[int, int], ...] = ()
    masks_i: List[np.ndarray] = field(default_factory=list)  # f32 [rh_i, rw_i]
    masks_j: List[np.ndarray] = field(default_factory=list)


def _overlap(roi_a, roi_b):
    ax, ay, aw, ah = roi_a
    bx, by, bw, bh = roi_b
    x0 = max(ax, bx)
    y0 = max(ay, by)
    x1 = min(ax + aw, bx + bw)
    y1 = min(ay + ah, by + bh)
    if x1 <= x0 or y1 <= y0:
        return None
    return (x0, y0, x1 - x0, y1 - y0)


def build_gain_plan(masks: List[np.ndarray], rois: List[tuple]) -> GainPlan:
    """masks: working-scale uint8 masks, one per image, each sized to its
    working roi; rois: working-scale canvas rects (x, y, w, h)."""
    n = len(masks)
    N = np.zeros((n, n), dtype=np.int64)
    plan = GainPlan(num_images=n, N=N, b=None, A_static=None, pairs=[])

    for i in range(n):
        N[i, i] = max(1, int(np.count_nonzero(masks[i])))
        for j in range(i + 1, n):
            ov = _overlap(rois[i], rois[j])
            if ov is None:
                N[i, j] = N[j, i] = 1
                continue
            ox, oy, ow, oh = ov
            ix, iy = ox - rois[i][0], oy - rois[i][1]
            jx, jy = ox - rois[j][0], oy - rois[j][1]
            sub_i = masks[i][iy : iy + oh, ix : ix + ow] > 0
            sub_j = masks[j][jy : jy + oh, jx : jx + ow] > 0
            inter = sub_i & sub_j
            N[i, j] = N[j, i] = max(1, int(inter.sum()))
            if not inter.any():
                continue
            mi = np.zeros(masks[i].shape, dtype=np.float32)
            mi[iy : iy + oh, ix : ix + ow] = inter
            mj = np.zeros(masks[j].shape, dtype=np.float32)
            mj[jy : jy + oh, jx : jx + ow] = inter
            plan.pairs.append((i, j))
            plan.masks_i.append(mi)
            plan.masks_j.append(mj)

    plan.b = (BETA * N.sum(axis=1)).astype(np.float32)
    plan.A_static = np.diag(BETA * N.sum(axis=1)).astype(np.float32)
    plan.N = tuple(tuple(int(v) for v in row) for row in N)
    plan.pairs = tuple(plan.pairs)
    return plan


def solve_gains(plan: GainPlan, norm_images):
    """norm_images: list of f32 [rh_i, rw_i] per-pixel luminance norms of
    the working-scale warped images.  Returns gains [n] f32.  Pure/jit-safe
    (plan contents are trace-time constants)."""
    n = plan.num_images
    I = jnp.zeros((n, n), dtype=jnp.float32)
    for (i, j), mi, mj in zip(plan.pairs, plan.masks_i, plan.masks_j):
        cnt = float(plan.N[i][j])
        I = I.at[i, j].set(jnp.sum(norm_images[i] * mi) / cnt)
        I = I.at[j, i].set(jnp.sum(norm_images[j] * mj) / cnt)

    Nf = jnp.asarray(np.array(plan.N, dtype=np.float32))
    off = 1.0 - jnp.eye(n, dtype=jnp.float32)
    diag_dyn = jnp.sum(2.0 * ALPHA * I * I * Nf * off, axis=1)
    A = (
        jnp.asarray(plan.A_static)
        + jnp.diag(diag_dyn)
        - 2.0 * ALPHA * I * I.T * Nf * off
    )
    return jnp.linalg.solve(A, jnp.asarray(plan.b))


register_plan(
    GainPlan,
    children=("b", "A_static", "masks_i", "masks_j"),
    static=("num_images", "N", "pairs"),
)
