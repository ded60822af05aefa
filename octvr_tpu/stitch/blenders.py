"""Fixed-geometry blenders (feather + multiband Laplacian).

Masks / ROIs / weight pyramids are fixed at plan time (the
"GPUStaticBlender" idea, stitching/src/blenders.cpp:479-736); the
per-frame work is pure dense math that lives inside the jitted stitch
step.  Canvas placement uses static slices (ROIs are compile-time
constants), so XLA sees fully static shapes.
"""

import math
from dataclasses import dataclass, field
from typing import List, Optional

import jax.numpy as jnp
import numpy as np
from scipy.ndimage import correlate1d, distance_transform_edt

from ..ops.pyramid import (
    down_matrix,
    pyr_down,
    pyr_down_mm,
    pyr_up,
    pyr_up_mm,
    up_matrix,
)
from ..utils.pytree import register_plan

_K5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0


def np_pyr_down(x):
    """NumPy twin of ops.pyramid.pyr_down for [H, W] arrays (plan-time
    only -- calling the jax version per template shape would trigger one
    device compilation per shape)."""
    y = correlate1d(x, _K5, axis=0, mode="mirror")
    y = correlate1d(y, _K5, axis=1, mode="mirror")
    return y[::2, ::2]

WEIGHT_EPS = 1e-5

__all__ = [
    "FeatherPlan",
    "MultiBandPlan",
    "build_feather_plan",
    "build_multiband_plan",
    "feather_blend",
    "multiband_blend",
]


def _union_roi(rois):
    x0 = min(r[0] for r in rois)
    y0 = min(r[1] for r in rois)
    x1 = max(r[0] + r[2] for r in rois)
    y1 = max(r[1] + r[3] for r in rois)
    return (x0, y0, x1 - x0, y1 - y0)


# --------------------------------------------------------------- feather


@dataclass
class FeatherPlan:
    rois: List[tuple]
    result_roi: tuple
    weights: List[np.ndarray]  # f32 [rh, rw], already normalized


register_plan(FeatherPlan, children=("weights",), static=("rois", "result_roi"))


def build_feather_plan(masks, rois, border: int) -> FeatherPlan:
    """weights = max(EDT(mask) - border, 0), normalized by the canvas total
    (blenders.cpp:531-594)."""
    result_roi = _union_roi(rois)
    rx, ry, rw, rh = result_roi
    dst_w = np.full((rh, rw), WEIGHT_EPS, dtype=np.float32)
    raw = []
    for m, roi in zip(masks, rois):
        w = distance_transform_edt(m > 0).astype(np.float32) - border
        np.maximum(w, 0.0, out=w)
        raw.append(w)
        ox, oy = roi[0] - rx, roi[1] - ry
        dst_w[oy : oy + roi[3], ox : ox + roi[2]] += w
    weights = []
    for w, roi in zip(raw, rois):
        ox, oy = roi[0] - rx, roi[1] - ry
        weights.append(w / dst_w[oy : oy + roi[3], ox : ox + roi[2]])
    return FeatherPlan(rois=list(rois), result_roi=result_roi, weights=weights)


def feather_blend(plan: FeatherPlan, imgs, canvas_size):
    """imgs: list of f32 [C, rh, rw] warped images.  Returns f32
    [C, H, W] canvas."""
    w, h = canvas_size
    c = imgs[0].shape[0]
    canvas = jnp.zeros((c, h, w), dtype=imgs[0].dtype)
    for img, wmap, roi in zip(imgs, plan.weights, plan.rois):
        x, y, rw, rh = roi
        contrib = img * jnp.asarray(wmap)[None]
        canvas = canvas.at[:, y : y + rh, x : x + rw].add(contrib)
    return canvas


# -------------------------------------------------------------- multiband


@dataclass
class MultiBandPlan:
    num_bands: int
    rois: List[tuple]
    align_rois: List[tuple]  # per-image padded rois, 2^bands aligned
    align_result_roi: tuple
    weight_pyrs: List[List[np.ndarray]]  # per image, per level
    # per level RECIPROCAL total band weight (canvas-aligned size): the
    # per-frame normalization is a multiply, not a divide (a vector
    # divide is multi-op on the VPU and this array is canvas-sized)
    inv_band_weights: List[np.ndarray]
    # banded pyramid matrices per axis length: {n: [n/2, n]}
    down_mats: dict = field(default_factory=dict)
    up_mats: dict = field(default_factory=dict)  # {n: [2n, n]}
    compute_dtype: str = "float32"  # "float32" | "bfloat16"


register_plan(
    MultiBandPlan,
    children=("weight_pyrs", "inv_band_weights", "down_mats", "up_mats"),
    static=(
        "num_bands",
        "rois",
        "align_rois",
        "align_result_roi",
        "compute_dtype",
    ),
)


def gather_dtype(blend_kind, compute_dtype, i, num_inputs):
    """Dtype input i leaves the remap gather in: the cameras of a
    multiband blend take its compute dtype straight from the gather
    (bf16 for a bf16 blend); feather and paste inputs, and overlays
    (pasted, not blended), stay float32."""
    if blend_kind == "multiband" and i < num_inputs:
        return compute_dtype
    return "float32"


def build_multiband_plan(
    seam_masks, rois, num_bands: int, canvas_size, dtype: str = "float32"
) -> MultiBandPlan:
    """Aligned-ROI geometry + precomputed Gaussian weight pyramids
    (blenders.cpp:594-668).

    ``dtype="bfloat16"`` stores the weight pyramids / banded matrices in
    bf16 and runs the per-frame pyramid math in bf16 with f32 matmul
    accumulation -- the 16-bit-precision analogue of the reference's
    CV_16S pyramid blenders (stitching/src/blenders.cpp:594-736), with
    half the memory traffic of float32."""
    assert num_bands >= 1
    result_roi = _union_roi(rois)
    step = 1 << num_bands

    def rdown(v):
        return (v >> num_bands) << num_bands

    def rup(v):
        return v + (step - v % step) % step

    arx = rdown(result_roi[0])
    ary = rdown(result_roi[1])
    arx1 = rup(result_roi[0] + result_roi[2])
    ary1 = rup(result_roi[1] + result_roi[3])
    align_result_roi = (arx, ary, arx1 - arx, ary1 - ary)

    gap = 5 * step
    align_rois = []
    for x, y, w, h in rois:
        left = max(arx, rdown(x) - gap)
        top = max(ary, rdown(y) - gap)
        right = min(arx1, rup(x + w) + gap)
        bottom = min(ary1, rup(y + h) + gap)
        assert (right - left) >> num_bands > 0
        assert (bottom - top) >> num_bands > 0
        align_rois.append((left, top, right - left, bottom - top))

    # per-image Gaussian weight pyramids from the seam masks
    weight_pyrs = []
    band_weights = [
        np.full(
            (align_result_roi[3] >> i, align_result_roi[2] >> i),
            WEIGHT_EPS,
            dtype=np.float32,
        )
        for i in range(num_bands + 1)
    ]
    for (x, y, w, h), (ax, ay, aw, ah), mask in zip(rois, align_rois, seam_masks):
        w0 = np.zeros((ah, aw), dtype=np.float32)
        w0[y - ay : y - ay + h, x - ax : x - ax + w] = (
            mask.astype(np.float32) / 255.0
        )
        pyr = [w0]
        for _ in range(num_bands):
            pyr.append(np_pyr_down(pyr[-1]))
        weight_pyrs.append(pyr)
        for i in range(num_bands + 1):
            ox, oy = (ax - arx) >> i, (ay - ary) >> i
            band_weights[i][
                oy : oy + (ah >> i), ox : ox + (aw >> i)
            ] += pyr[i]

    # banded matrices for every axis length the blend touches
    down_mats, up_mats = {}, {}
    lengths = set()
    for (ax, ay, aw, ah) in align_rois + [align_result_roi]:
        for l in range(num_bands + 1):
            lengths.add(aw >> l)
            lengths.add(ah >> l)
    for nl in lengths:
        if nl >= 2:
            down_mats[nl] = down_matrix(nl)
            up_mats[nl >> 1] = up_matrix(nl >> 1)

    if dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"multiband dtype must be 'float32' or 'bfloat16', got {dtype!r}"
        )
    inv_band_weights = [(1.0 / b).astype(np.float32) for b in band_weights]
    if dtype == "bfloat16":
        # bf16 has no native numpy dtype; jax's bfloat16 scalar type is one
        bd = np.dtype(jnp.bfloat16)
        weight_pyrs = [[p.astype(bd) for p in pyr] for pyr in weight_pyrs]
        inv_band_weights = [b.astype(bd) for b in inv_band_weights]
        down_mats = {k: v.astype(bd) for k, v in down_mats.items()}
        up_mats = {k: v.astype(bd) for k, v in up_mats.items()}

    return MultiBandPlan(
        num_bands=num_bands,
        rois=list(rois),
        align_rois=align_rois,
        align_result_roi=align_result_roi,
        weight_pyrs=weight_pyrs,
        inv_band_weights=inv_band_weights,
        down_mats=down_mats,
        up_mats=up_mats,
        compute_dtype=dtype,
    )


def multiband_blend(plan: MultiBandPlan, imgs, canvas_size):
    """imgs: f32 [C, rh, rw] warped images (roi-sized).  Builds per-image
    Laplacian pyramids, accumulates weighted bands, normalizes, collapses
    (blenders.cpp:676-736 semantics, f32 instead of 8-bit pyramids)."""
    B = plan.num_bands
    arx, ary, arw, arh = plan.align_result_roi
    c = imgs[0].shape[0]
    out_dtype = jnp.float32  # canvas is always f32 (feeds YUV pack)
    dtype = jnp.dtype(plan.compute_dtype)

    dst_pyr = [
        jnp.zeros((c, arh >> i, arw >> i), dtype=dtype) for i in range(B + 1)
    ]

    def down(z):
        _, hh, ww = z.shape
        if hh in plan.down_mats and ww in plan.down_mats:
            return pyr_down_mm(
                z, plan.down_mats[hh], plan.down_mats[ww]
            ).astype(dtype)
        return pyr_down(z.astype(jnp.float32)).astype(dtype)

    def up(z):
        _, hh, ww = z.shape
        if hh in plan.up_mats and ww in plan.up_mats:
            return pyr_up_mm(z, plan.up_mats[hh], plan.up_mats[ww]).astype(
                dtype
            )
        return pyr_up(z.astype(jnp.float32)).astype(dtype)

    for img, roi, aroi, wpyr in zip(imgs, plan.rois, plan.align_rois, plan.weight_pyrs):
        x, y, w, h = roi
        ax, ay, aw, ah = aroi
        src0 = jnp.zeros((c, ah, aw), dtype=dtype)
        src0 = src0.at[:, y - ay : y - ay + h, x - ax : x - ax + w].set(
            img.astype(dtype)
        )
        gauss = [src0]
        for _ in range(B):
            gauss.append(down(gauss[-1]))
        for i in range(B + 1):
            if i < B:
                lap = gauss[i] - up(gauss[i + 1])
            else:
                lap = gauss[B]
            contrib = lap * jnp.asarray(wpyr[i])[None]
            ox, oy = (ax - arx) >> i, (ay - ary) >> i
            dst_pyr[i] = dst_pyr[i].at[
                :, oy : oy + (ah >> i), ox : ox + (aw >> i)
            ].add(contrib)

    for i in range(B + 1):
        dst_pyr[i] = dst_pyr[i] * jnp.asarray(plan.inv_band_weights[i])[None]

    acc = dst_pyr[B]
    for i in range(B - 1, -1, -1):
        acc = up(acc) + dst_pyr[i]

    w, h = canvas_size
    canvas = jnp.zeros((c, h, w), dtype=out_dtype)
    cw = min(arw, w - arx)
    ch = min(arh, h - ary)
    canvas = canvas.at[:, ary : ary + ch, arx : arx + cw].set(
        acc[:, :ch, :cw].astype(out_dtype)
    )
    return canvas
