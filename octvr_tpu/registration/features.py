"""ORB-style feature detection + description, array-vectorized.

Re-imagines the reference's grid ORB finder (stitching/src/matchers.cpp:
389-460) as fixed-shape array ops: FAST-9 corners and Harris responses
are computed for *every* pixel as elementwise/conv math,
per-grid-cell top-k replaces the per-cell ORB budget, orientation comes
from intensity centroids (conv), and descriptors are rotated binary
tests (rBRIEF).  The binary test pattern is our own seeded random-pair
pattern (BRIEF-style), not OpenCV's learned table — descriptors are only
matched against each other, so self-consistency is what matters.

Everything is jittable with a static keypoint budget; invalid slots are
masked, never dropped (no dynamic shapes).
"""

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.pytree import register_plan

__all__ = [
    "ImageFeatures",
    "detect_and_describe",
    "detect_and_describe_pyramid",
    "rgb_to_gray",
]

# FAST radius-3 Bresenham circle, clockwise from 12 o'clock
_CIRCLE = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
        (-1, 3),
    ],
    dtype=np.int32,
)  # (dx, dy)

PATCH_R = 15  # orientation / descriptor patch radius (ORB uses 31x31)


def _brief_pattern(n_tests=256, patch_r=PATCH_R, seed=42):
    """Random Gaussian point pairs clipped to the patch (BRIEF-II)."""
    rng = np.random.default_rng(seed)
    sigma = patch_r / 2.5
    pts = rng.normal(0.0, sigma, size=(n_tests, 2, 2))
    return np.clip(np.round(pts), -patch_r, patch_r).astype(np.float32)


_PATTERN = _brief_pattern()


@dataclass
class ImageFeatures:
    keypoints: object  # [K, 2] f32 (x, y) pixel coords
    response: object  # [K] f32
    angle: object  # [K] f32 radians
    descriptors: object  # [K, 256] f32 in {-1, +1}
    valid: object  # [K] bool
    img_size: tuple  # (w, h)


register_plan(
    ImageFeatures,
    children=("keypoints", "response", "angle", "descriptors", "valid"),
    static=("img_size",),
)


def rgb_to_gray(rgb):
    """[H, W, 3] or [3, H, W] float -> [H, W] luminance (BT.601)."""
    if rgb.ndim == 3 and rgb.shape[0] == 3:
        rgb = jnp.moveaxis(rgb, 0, -1)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def _shift2d(img, dx, dy):
    """Shifted copy with zero fill (value at (y+dy, x+dx))."""
    return jnp.roll(img, shift=(-dy, -dx), axis=(0, 1))


def _fast_score(gray, threshold):
    """FAST-9 corner mask + Harris-style ranking response."""
    c = gray
    ring = jnp.stack(
        [_shift2d(gray, int(dx), int(dy)) for dx, dy in _CIRCLE]
    )  # [16, H, W]
    bright = (ring > c[None] + threshold).astype(jnp.int32)
    dark = (ring < c[None] - threshold).astype(jnp.int32)

    def has_run9(mask):
        run = jnp.zeros_like(mask[0])
        found = jnp.zeros_like(mask[0], dtype=bool)
        # sum of each 9-long circular window
        for s in range(16):
            win = sum(mask[(s + k) % 16] for k in range(9))
            found = found | (win == 9)
        return found

    corner = has_run9(bright) | has_run9(dark)

    # Harris response for ranking (ORB's HARRIS_SCORE)
    ix = (_shift2d(gray, 1, 0) - _shift2d(gray, -1, 0)) * 0.5
    iy = (_shift2d(gray, 0, 1) - _shift2d(gray, 0, -1)) * 0.5

    def blur7(x):
        out = x
        kernel = jnp.ones((7, 1), dtype=x.dtype) / 7.0
        out = jax.lax.conv_general_dilated(
            out[None, None], kernel[None, None],
            window_strides=(1, 1), padding=[(3, 3), (0, 0)],
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
        )[0, 0]
        kernel2 = jnp.ones((1, 7), dtype=x.dtype) / 7.0
        out = jax.lax.conv_general_dilated(
            out[None, None], kernel2[None, None],
            window_strides=(1, 1), padding=[(0, 0), (3, 3)],
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
        )[0, 0]
        return out

    sxx = blur7(ix * ix)
    syy = blur7(iy * iy)
    sxy = blur7(ix * iy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    harris = det - 0.04 * tr * tr

    resp = jnp.where(corner, harris, -jnp.inf)
    # 3x3 non-max suppression
    neigh = jnp.stack(
        [
            _shift2d(resp, dx, dy)
            for dx in (-1, 0, 1)
            for dy in (-1, 0, 1)
            if (dx, dy) != (0, 0)
        ]
    )
    nms = resp >= neigh.max(axis=0)
    resp = jnp.where(corner & nms, harris, -jnp.inf)

    # kill the border (patch radius + circle)
    h, w = gray.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    b = PATCH_R + 4
    interior = (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)
    return jnp.where(interior, resp, -jnp.inf)


def _orientation_maps(gray):
    """Intensity-centroid angle for every pixel (conv with x/y-weighted
    circular kernels, radius PATCH_R)."""
    r = PATCH_R
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    circ = (xs * xs + ys * ys <= r * r).astype(np.float32)
    kx = jnp.asarray(xs * circ)
    ky = jnp.asarray(ys * circ)

    def conv(img, k):
        return jax.lax.conv_general_dilated(
            img[None, None],
            k[None, None],
            window_strides=(1, 1),
            padding=[(r, r), (r, r)],
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
        )[0, 0]

    m10 = conv(gray, kx)
    m01 = conv(gray, ky)
    return jnp.arctan2(m01, m10)


def _box5(gray):
    k = jnp.ones((5, 1), dtype=gray.dtype) / 5.0
    out = jax.lax.conv_general_dilated(
        gray[None, None], k[None, None], (1, 1), [(2, 2), (0, 0)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0]
    k2 = jnp.ones((1, 5), dtype=gray.dtype) / 5.0
    return jax.lax.conv_general_dilated(
        out[None, None], k2[None, None], (1, 1), [(0, 0), (2, 2)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0]


@partial(jax.jit, static_argnames=("max_features", "grid"))
def detect_and_describe(gray, max_features=1000, grid=(3, 1), threshold=12.0):
    """gray: [H, W] f32 in [0, 255].  Returns ImageFeatures with a static
    keypoint budget of ``max_features`` (rounded up to fill the grid)."""
    h, w = gray.shape
    gw, gh = grid
    resp = _fast_score(gray, threshold)

    # per-cell budget, like OrbFeaturesFinder (matchers.cpp:391-393)
    cells = gw * gh
    per_cell = max(1, (max_features * (99 + cells) // 100) // cells)

    kxs, kys, kresp = [], [], []
    for r in range(gh):
        for c in range(gw):
            y0, y1 = r * h // gh, (r + 1) * h // gh
            x0, x1 = c * w // gw, (c + 1) * w // gw
            sub = resp[y0:y1, x0:x1].reshape(-1)
            vals, idx = jax.lax.top_k(sub, per_cell)
            cy = idx // (x1 - x0) + y0
            cx = idx % (x1 - x0) + x0
            kxs.append(cx)
            kys.append(cy)
            kresp.append(vals)
    kx = jnp.concatenate(kxs)
    ky = jnp.concatenate(kys)
    kresp = jnp.concatenate(kresp)
    valid = jnp.isfinite(kresp)

    angle_map = _orientation_maps(gray)
    angles = angle_map[ky, kx]

    # rBRIEF: rotate the test pattern by each keypoint's angle, sample the
    # 5x5-box-smoothed image
    sm = _box5(gray)
    pat = jnp.asarray(_PATTERN)  # [256, 2, 2] (pair, point, xy)
    ca, sa = jnp.cos(angles), jnp.sin(angles)
    # rotated offsets per keypoint: [K, 256, 2, 2]
    px = pat[None, :, :, 0] * ca[:, None, None] - pat[None, :, :, 1] * sa[:, None, None]
    py = pat[None, :, :, 0] * sa[:, None, None] + pat[None, :, :, 1] * ca[:, None, None]
    sx = jnp.clip(
        jnp.round(kx[:, None, None] + px).astype(jnp.int32), 0, w - 1
    )
    sy = jnp.clip(
        jnp.round(ky[:, None, None] + py).astype(jnp.int32), 0, h - 1
    )
    flat = sm.reshape(-1)
    samples = jnp.take(flat, sy * w + sx)  # [K, 256, 2]
    desc = jnp.where(samples[:, :, 0] < samples[:, :, 1], 1.0, -1.0).astype(
        jnp.float32
    )
    desc = jnp.where(valid[:, None], desc, 0.0)

    return ImageFeatures(
        keypoints=jnp.stack([kx, ky], axis=-1).astype(jnp.float32),
        response=jnp.where(valid, kresp, 0.0),
        angle=angles,
        descriptors=desc,
        valid=valid,
        img_size=(w, h),
    )


def detect_and_describe_pyramid(
    gray,
    max_features=1500,
    levels=4,
    scale=1.25,
    grid=(3, 1),
    threshold=12.0,
):
    """Multi-scale detection: ORB's image pyramid (matchers.cpp ORB uses
    nlevels with scaleFactor 1.3; SURF's octaves play the same role,
    matchers.cpp:365-389).  Each level runs the fixed-budget detector on
    a downscaled image; keypoints map back to level-0 pixel coordinates
    and the per-level features concatenate into one ImageFeatures.

    Per-level budgets follow ORB's geometric split (proportional to
    level area, factor 1/scale^2)."""
    import math

    from ..ops.resize import resize_bilinear

    h, w = gray.shape
    q = 1.0 / (scale * scale)
    norm = (1.0 - q**levels) / (1.0 - q)
    budgets = [
        max(8, int(round(max_features * (q**l) / norm))) for l in range(levels)
    ]

    gray = jnp.asarray(gray)
    parts = []
    img = gray
    for l in range(levels):
        if l:
            nh = max(2 * PATCH_R + 10, int(round(h / scale**l)))
            nw = max(2 * PATCH_R + 10, int(round(w / scale**l)))
            img = jnp.asarray(
                resize_bilinear(np.asarray(gray), nh, nw)
            )
        f = detect_and_describe(
            img, max_features=budgets[l], grid=grid, threshold=threshold
        )
        sx = w / img.shape[1]
        sy = h / img.shape[0]
        parts.append(
            (
                np.asarray(f.keypoints) * np.array([sx, sy], np.float32),
                np.asarray(f.response),
                np.asarray(f.angle),
                np.asarray(f.descriptors),
                np.asarray(f.valid),
            )
        )
    return ImageFeatures(
        keypoints=np.concatenate([p[0] for p in parts]),
        response=np.concatenate([p[1] for p in parts]),
        angle=np.concatenate([p[2] for p in parts]),
        descriptors=np.concatenate([p[3] for p in parts]),
        valid=np.concatenate([p[4] for p in parts]),
        img_size=(w, h),
    )
