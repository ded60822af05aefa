#!/usr/bin/env python
"""Real-photograph alignment demo (VERDICT r4 next #4).

Recovers the graf1 -> graf3 homography with the full features ->
2-NN match -> RANSAC pipeline on the reference's own fixture pair
(samples/data/graf{1,3}.png, ground truth H1to3p.xml), then warps
graf3 back into graf1's frame and composites a mosaic:

* left half of the output: graf1 pixels,
* right half: bilinear-warped graf3 pixels,
* seam down the middle — alignment quality is visible as the
  continuity of the poster features across the seam.

The scene is PLANAR with camera translation, so a homography (not the
rotating-camera model the Stitcher facade assumes) is the correct
alignment model — exactly the matchers.cpp:581-658 use case.

Writes docs/assets/graf_mosaic.png and prints overlap statistics.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def recover_h(g1, g3, scale=2):
    import jax

    # registration of two small images is CPU work
    jax.config.update("jax_platforms", "cpu")

    from octvr_tpu.registration.features import detect_and_describe_pyramid
    from octvr_tpu.registration.matchers import (
        find_homography_ransac,
        match_pair,
    )

    def gray(im):
        return (
            0.299 * im[..., 0] + 0.587 * im[..., 1] + 0.114 * im[..., 2]
        )

    def down2(a):
        return (
            a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2]
        ) * 0.25

    d1, d3 = gray(g1), gray(g3)
    for _ in range(scale // 2):
        d1, d3 = down2(d1), down2(d3)
    f1 = detect_and_describe_pyramid(
        d1, max_features=1200, levels=3, grid=(4, 3)
    )
    f3 = detect_and_describe_pyramid(
        d3, max_features=1200, levels=3, grid=(4, 3)
    )
    pairs, _ = match_pair(f1, f3)
    src = np.asarray(f1.keypoints)[pairs[:, 0]]
    dst = np.asarray(f3.keypoints)[pairs[:, 1]]
    H, inl = find_homography_ransac(src, dst, seed=0)
    if H is None:
        raise RuntimeError("homography recovery failed")
    S = np.diag([scale, scale, 1.0])
    H_full = S @ (H / H[2, 2]) @ np.linalg.inv(S)
    return H_full, int(inl.sum()), len(pairs)


def warp_h(img, H, out_h, out_w):
    """Bilinear warp: out[y, x] = img(H @ [x, y, 1])."""
    ys, xs = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    q = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ H.T
    u = q[..., 0] / q[..., 2]
    v = q[..., 1] / q[..., 2]
    h, w = img.shape[:2]
    valid = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    u = np.clip(u, 0, w - 1)
    v = np.clip(v, 0, h - 1)
    x0 = np.floor(u).astype(int)
    y0 = np.floor(v).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fu = (u - x0)[..., None]
    fv = (v - y0)[..., None]
    im = img.astype(np.float64)
    out = (
        im[y0, x0] * (1 - fu) * (1 - fv)
        + im[y0, x1] * fu * (1 - fv)
        + im[y1, x0] * (1 - fu) * fv
        + im[y1, x1] * fu * fv
    )
    return out, valid


def main():
    from octvr_tpu.utils.png import read_png, write_png

    data = "/root/reference/samples/data"
    g1 = read_png(os.path.join(data, "graf1.png")).astype(np.float32)
    g3 = read_png(os.path.join(data, "graf3.png")).astype(np.float32)

    H, ninl, npairs = recover_h(g1, g3)
    print(f"# recovered H: {ninl}/{npairs} inliers", file=sys.stderr)

    h, w = g1.shape[:2]
    warped, valid = warp_h(g3, H, h, w)  # graf3 seen from graf1's frame

    ov = valid & (g1.sum(axis=-1) > 0)
    diff = np.abs(warped - g1)[ov]
    print(
        f"# overlap {ov.mean()*100:.0f}% of frame, "
        f"mean |warped(graf3) - graf1| = {diff.mean():.1f}/255 "
        f"(lighting differs between exposures; alignment shows as "
        f"structure continuity, see the mosaic)",
        file=sys.stderr,
    )

    # vertical-stripe composite: alternating 64-px columns from graf1
    # and the warped graf3 — misalignment would break every edge at
    # every stripe boundary
    mosaic = g1.copy()
    stripes = (np.arange(w) // 64) % 2 == 1
    mosaic[:, stripes] = np.where(
        valid[:, stripes, None], warped[:, stripes], g1[:, stripes]
    )
    out_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs",
        "assets",
    )
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "graf_mosaic.png")
    write_png(out_path, np.clip(mosaic, 0, 255).astype(np.uint8))
    print(out_path)


if __name__ == "__main__":
    main()
