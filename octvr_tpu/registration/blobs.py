"""SURF-role multi-scale blob detector + float descriptor, array-vectorized.

The reference's stitching registration defaults to SURF
(stitching/src/matchers.cpp:365-389, matchers.hpp:136): a Hessian-based
blob detector with a gradient-statistics float descriptor.  Its value on
low-texture rigs (sky, walls, defocus) is that blobs respond where FAST
corners don't.  This is an array-first equivalent, not a SURF port:

* determinant-of-Hessian response over a geometric scale stack,
  computed as separable Gaussian convs + central differences for every
  pixel (elementwise-friendly, no integral-image/Haar box tricks — those are
  CPU-era approximations of exactly these Gaussian derivatives),
* 3x3x3 (scale, y, x) non-max suppression as shifted-stack maxima,
* fixed per-grid-cell keypoint budgets via top_k (static shapes, no
  dynamic keypoint counts),
* SURF-style descriptor: a 16x16 grid of scale-adapted, rotated
  gradient samples, folded into 4x4 subregions of (sum dx, sum dy,
  sum |dx|, sum |dy|) = 64 floats, L2-normalized.

Descriptors are scaled to L2 norm 16 (norm^2 = 256) so the matcher's
(256 - dot)/2 distance — squared L2 up to an affine map for any
equal-norm family — works unchanged for both rBRIEF (+-1^256) and these
float descriptors.
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .features import ImageFeatures

__all__ = ["detect_and_describe_blobs"]


def _gauss_kernel(sigma):
    r = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32), r


def _sep_conv(img, k, r, axis):
    """Separable 1-D convolution along ``axis`` with edge padding."""
    if axis == 0:
        kern = k.reshape(-1, 1)
        pad = [(r, r), (0, 0)]
    else:
        kern = k.reshape(1, -1)
        pad = [(0, 0), (r, r)]
    img = jnp.pad(img, pad, mode="edge")
    return jax.lax.conv_general_dilated(
        img[None, None],
        jnp.asarray(kern)[None, None],
        window_strides=(1, 1),
        padding=[(0, 0), (0, 0)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0]


def _smooth(img, sigma):
    k, r = _gauss_kernel(sigma)
    return _sep_conv(_sep_conv(img, jnp.asarray(k), r, 0), jnp.asarray(k), r, 1)


def _roll3(vol, ds, dy, dx):
    return jnp.roll(vol, shift=(-ds, -dy, -dx), axis=(0, 1, 2))


@partial(
    jax.jit,
    static_argnames=("max_features", "grid", "n_scales", "threshold"),
)
def detect_and_describe_blobs(
    gray,
    max_features=1000,
    grid=(3, 1),
    n_scales=5,
    sigma0=1.6,
    scale_step=1.4,
    threshold=4.0,
):
    """gray: [H, W] f32 in [0, 255].  Returns ImageFeatures with a static
    keypoint budget (same contract as detect_and_describe)."""
    h, w = gray.shape
    sigmas = [sigma0 * scale_step**i for i in range(n_scales)]

    # ---- determinant-of-Hessian stack, sigma-normalized
    resp_s, gx_s, gy_s = [], [], []
    for s in sigmas:
        L = _smooth(gray, s)
        d = max(1, int(round(s)))  # derivative spacing tracks scale

        def sh(img, dy, dx):
            return jnp.roll(img, shift=(-dy, -dx), axis=(0, 1))

        lxx = (sh(L, 0, d) + sh(L, 0, -d) - 2.0 * L) / (d * d)
        lyy = (sh(L, d, 0) + sh(L, -d, 0) - 2.0 * L) / (d * d)
        lxy = (
            sh(L, d, d) - sh(L, d, -d) - sh(L, -d, d) + sh(L, -d, -d)
        ) / (4.0 * d * d)
        doh = (s**4) * (lxx * lyy - (0.9 * lxy) ** 2)
        resp_s.append(doh)
        gx_s.append((sh(L, 0, 1) - sh(L, 0, -1)) * 0.5)
        gy_s.append((sh(L, 1, 0) - sh(L, -1, 0)) * 0.5)

    resp = jnp.stack(resp_s)  # [NS, H, W]
    gx = jnp.stack(gx_s)
    gy = jnp.stack(gy_s)

    # ---- 3x3x3 non-max suppression (scale ends clamp via edge pad)
    neigh = [
        _roll3(resp, ds, dy, dx)
        for ds in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if (ds, dy, dx) != (0, 0, 0)
    ]
    is_max = resp >= jnp.stack(neigh).max(axis=0)
    score = jnp.where(is_max & (resp > threshold), resp, -jnp.inf)

    # kill borders (descriptor window: 10*sigma + rotation margin)
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    borders = jnp.stack(
        [
            jnp.where(
                (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b),
                0.0,
                -jnp.inf,
            )
            for b in [max(8, int(math.ceil(3.0 * s))) for s in sigmas]
        ]
    )
    score = score + borders

    # ---- per-grid-cell top-k over (scale, y, x) — the grid budget of
    # the reference's grid finders (matchers.cpp:391-393)
    gw, gh = grid
    cells = gw * gh
    per_cell = max(1, (max_features * (99 + cells) // 100) // cells)
    kss, kys, kxs, kresp = [], [], [], []
    for r in range(gh):
        for c in range(gw):
            y0, y1 = r * h // gh, (r + 1) * h // gh
            x0, x1 = c * w // gw, (c + 1) * w // gw
            cw = x1 - x0
            ch = y1 - y0
            sub = score[:, y0:y1, x0:x1].reshape(-1)
            vals, idx = jax.lax.top_k(sub, per_cell)
            si = idx // (ch * cw)
            rem = idx % (ch * cw)
            kss.append(si)
            kys.append(rem // cw + y0)
            kxs.append(rem % cw + x0)
            kresp.append(vals)
    ks = jnp.concatenate(kss)
    ky = jnp.concatenate(kys)
    kx = jnp.concatenate(kxs)
    kresp = jnp.concatenate(kresp)
    valid = jnp.isfinite(kresp)

    # ---- orientation: angle of the Gaussian-smoothed gradient summed
    # over a ring around the blob (the center gradient of a blob is ~0;
    # the 8-point ring at radius 3*sigma is where SURF's Haar sector sum
    # gets its signal)
    sig_arr = jnp.asarray(np.array(sigmas, np.float32))
    ksig = sig_arr[ks]
    ring = [
        (math.cos(2 * math.pi * t / 8.0), math.sin(2 * math.pi * t / 8.0))
        for t in range(8)
    ]
    # per-keypoint-scale gradient gathers: linear index into [NS*H*W]
    fgx = gx.reshape(-1)
    fgy = gy.reshape(-1)

    def ring_sum(offsets):
        sx_ = jnp.zeros_like(kresp)
        sy_ = jnp.zeros_like(kresp)
        for cx_r, cy_r in offsets:
            px = jnp.clip(
                jnp.round(kx + 3.0 * ksig * cx_r).astype(jnp.int32),
                0,
                w - 1,
            )
            py = jnp.clip(
                jnp.round(ky + 3.0 * ksig * cy_r).astype(jnp.int32),
                0,
                h - 1,
            )
            lin = ks * (h * w) + py * w + px
            sx_ = sx_ + jnp.take(fgx, lin)
            sy_ = sy_ + jnp.take(fgy, lin)
        return sx_, sy_

    gsx, gsy = ring_sum(ring + [(0.0, 0.0)])
    angles = jnp.arctan2(gsy, gsx)

    # ---- SURF-style descriptor: 16x16 rotated, scale-adapted gradient
    # samples -> 4x4 subregions x (sum dx', sum dy', sum |dx'|, sum |dy'|)
    G = 16
    half = (G - 1) / 2.0
    uu, vv = np.meshgrid(
        (np.arange(G) - half) / half, (np.arange(G) - half) / half,
        indexing="xy",
    )  # in [-1, 1]
    uu = jnp.asarray(uu.reshape(-1).astype(np.float32))  # [G*G]
    vv = jnp.asarray(vv.reshape(-1).astype(np.float32))
    ca, sa = jnp.cos(angles), jnp.sin(angles)
    rad = 10.0 * ksig  # window half-extent
    # rotated sample positions [K, G*G]
    px = kx[:, None] + rad[:, None] * (
        uu[None] * ca[:, None] - vv[None] * sa[:, None]
    )
    py = ky[:, None] + rad[:, None] * (
        uu[None] * sa[:, None] + vv[None] * ca[:, None]
    )
    sxi = jnp.clip(jnp.round(px).astype(jnp.int32), 0, w - 1)
    syi = jnp.clip(jnp.round(py).astype(jnp.int32), 0, h - 1)
    lin = ks[:, None] * (h * w) + syi * w + sxi
    sdx = jnp.take(fgx, lin)  # [K, G*G]
    sdy = jnp.take(fgy, lin)
    # rotate gradients into the keypoint frame
    rdx = sdx * ca[:, None] + sdy * sa[:, None]
    rdy = -sdx * sa[:, None] + sdy * ca[:, None]
    # Gaussian weighting over the window (SURF's sigma = 3.3s over 20s)
    wgt = jnp.exp(-0.5 * ((uu**2 + vv**2) / (0.55**2)))[None]
    rdx = rdx * wgt
    rdy = rdy * wgt
    # fold into 4x4 subregions
    k_ = rdx.shape[0]
    sub = lambda a: a.reshape(k_, 4, 4, 4, 4).sum(axis=(2, 4))  # noqa: E731
    rdx2 = rdx.reshape(k_, G, G)
    rdy2 = rdy.reshape(k_, G, G)
    feats = jnp.stack(
        [
            sub(rdx2),
            sub(rdy2),
            sub(jnp.abs(rdx2)),
            sub(jnp.abs(rdy2)),
        ],
        axis=-1,
    ).reshape(k_, 64)
    nrm = jnp.sqrt(jnp.sum(feats * feats, axis=1, keepdims=True))
    desc = 16.0 * feats / jnp.maximum(nrm, 1e-6)
    desc = jnp.where(valid[:, None], desc, 0.0)

    return ImageFeatures(
        keypoints=jnp.stack([kx, ky], axis=-1).astype(jnp.float32),
        response=jnp.where(valid, kresp, 0.0),
        angle=angles,
        descriptors=desc,
        valid=valid,
        img_size=(w, h),
    )
