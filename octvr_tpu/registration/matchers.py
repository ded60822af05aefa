"""Pairwise feature matching + robust homography estimation.

Matmul-first redesign of BestOf2NearestMatcher (stitching/src/matchers.cpp:
144-226, 581-658): Hamming distances of +-1 descriptor matrices are one
matmul; 2-NN + ratio test both directions with set
union; RANSAC runs as a *batch* of hypotheses (vectorized 4-point DLT +
inlier counting as matmuls) instead of a sequential loop; confidence is
Brown-Lowe num_inliers / (8 + 0.3 * num_matches).
"""

import math
from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .features import ImageFeatures

__all__ = ["MatchesInfo", "match_pair", "find_homography_ransac"]


@dataclass
class MatchesInfo:
    src_idx: int = -1
    dst_idx: int = -1
    pairs: Optional[np.ndarray] = None  # [M, 2] int32 keypoint index pairs
    valid: Optional[np.ndarray] = None  # [M] bool (ratio-test survivors)
    inliers: Optional[np.ndarray] = None  # [M] bool (RANSAC)
    num_inliers: int = 0
    H: Optional[np.ndarray] = None  # [3, 3] f64 or None
    confidence: float = 0.0


@partial(jax.jit, static_argnames=())
def _two_nn(d1, valid1, d2, valid2):
    """Hamming 2-NN via one matmul.  d*: [K, 256] in {-1,+1} (0 rows
    invalid).  The products are +-1 and the sums integers of magnitude
    <= 256, exact in TF32 and bf16 alike, so the default precision is
    exact."""
    dot = jnp.matmul(d1, d2.T, precision=jax.lax.Precision.DEFAULT)  # [K1, K2]
    ham = (256.0 - dot) * 0.5
    big = 1e9
    ham = jnp.where(valid1[:, None] & valid2[None, :], ham, big)
    top2, idx2 = jax.lax.top_k(-ham, 2)
    return -top2, idx2  # distances [K1, 2], indices [K1, 2]


def match_pair(f1: ImageFeatures, f2: ImageFeatures, match_conf=0.3):
    """2-NN ratio matching both directions with union (CpuMatcher
    semantics).  Returns (pairs [M,2], valid [M]) as numpy."""
    d12, i12 = _two_nn(f1.descriptors, f1.valid, f2.descriptors, f2.valid)
    d21, i21 = _two_nn(f2.descriptors, f2.valid, f1.descriptors, f1.valid)
    d12, i12, d21, i21 = (np.asarray(a) for a in (d12, i12, d21, i21))
    ratio = 1.0 - match_conf

    chosen = set()
    pairs = []
    k1 = d12.shape[0]
    ok12 = d12[:, 0] < ratio * np.maximum(d12[:, 1], 1e-6)
    for q in np.flatnonzero(ok12):
        pairs.append((q, i12[q, 0]))
        chosen.add((q, int(i12[q, 0])))
    ok21 = d21[:, 0] < ratio * np.maximum(d21[:, 1], 1e-6)
    for q in np.flatnonzero(ok21):
        pair = (int(i21[q, 0]), q)
        if pair not in chosen:
            pairs.append(pair)
    if not pairs:
        return np.zeros((0, 2), np.int32), np.zeros((0,), bool)
    pairs = np.asarray(pairs, dtype=np.int32)
    return pairs, np.ones(len(pairs), dtype=bool)


def _dlt(src, dst, weights=None):
    """Homography by DLT (numpy f64).  src/dst [M, 2]."""
    m = src.shape[0]
    if weights is None:
        weights = np.ones(m)
    a = np.zeros((2 * m, 9))
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    w = weights
    a[0::2, 0] = -x * w
    a[0::2, 1] = -y * w
    a[0::2, 2] = -w
    a[0::2, 6] = u * x * w
    a[0::2, 7] = u * y * w
    a[0::2, 8] = u * w
    a[1::2, 3] = -x * w
    a[1::2, 4] = -y * w
    a[1::2, 5] = -w
    a[1::2, 6] = v * x * w
    a[1::2, 7] = v * y * w
    a[1::2, 8] = v * w
    _, _, vt = np.linalg.svd(a, full_matrices=False)
    h = vt[-1].reshape(3, 3)
    if abs(h[2, 2]) > 1e-12:
        h = h / h[2, 2]
    return h


def _project(H, pts):
    p = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ H.T
    z = p[:, 2:3]
    z = np.where(np.abs(z) < 1e-12, 1e-12, z)
    return p[:, :2] / z


def find_homography_ransac(
    src, dst, iters=1024, thresh=3.0, seed=0, min_matches=4
):
    """Batched-hypothesis RANSAC homography (numpy f64 host path; the
    4-point solves and inlier counts are vectorized over all hypotheses).
    Returns (H, inlier_mask) or (None, None)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    m = len(src)
    if m < min_matches:
        return None, None

    rng = np.random.default_rng(seed)
    samples = rng.integers(0, m, size=(iters, 4))
    # reject degenerate samples lazily: their H will simply fit poorly
    best_h, best_count, best_mask = None, -1, None

    # batched 4-point DLT via per-hypothesis SVD
    a = np.zeros((iters, 8, 9))
    s = src[samples]  # [B, 4, 2]
    d = dst[samples]
    x, y = s[..., 0], s[..., 1]
    u, v = d[..., 0], d[..., 1]
    a[:, 0::2, 0] = -x
    a[:, 0::2, 1] = -y
    a[:, 0::2, 2] = -1
    a[:, 0::2, 6] = u * x
    a[:, 0::2, 7] = u * y
    a[:, 0::2, 8] = u
    a[:, 1::2, 3] = -x
    a[:, 1::2, 4] = -y
    a[:, 1::2, 5] = -1
    a[:, 1::2, 6] = v * x
    a[:, 1::2, 7] = v * y
    a[:, 1::2, 8] = v
    _, _, vt = np.linalg.svd(a, full_matrices=True)
    hs = vt[:, -1].reshape(iters, 3, 3)  # [B, 3, 3]

    # count inliers for every hypothesis at once
    ones = np.ones((m, 1))
    pts = np.concatenate([src, ones], axis=1)  # [M, 3]
    proj = np.einsum("bij,mj->bmi", hs, pts)
    z = proj[..., 2]
    z = np.where(np.abs(z) < 1e-12, 1e-12, z)
    pp = proj[..., :2] / z[..., None]
    err = np.linalg.norm(pp - dst[None], axis=-1)
    inl = err < thresh
    counts = inl.sum(axis=1)
    best = int(np.argmax(counts))
    best_count = int(counts[best])
    if best_count < min_matches:
        return None, None
    best_mask = inl[best]

    return _refit_inliers(src, dst, best_mask, thresh, min_matches)


def _spans_2d(pts, mask, thresh):
    """True when the masked points span a genuinely 2-D region: the
    minor axis of their scatter must exceed the inlier threshold band.
    A rank-deficient homography maps the plane onto a LINE, so its
    "inliers" all sit within ~thresh of that line — a chance-level
    model on unmatchable pairs (observed on aero1/aero3: 10 inliers,
    2nd singular value ~1e-14) that this rejects while any real
    alignment, whose support spreads in two dimensions, passes."""
    p = pts[mask]
    c = p - p.mean(axis=0)
    ev = np.linalg.eigvalsh(c.T @ c / len(p))
    return ev[0] > (2.0 * thresh) ** 2


def _refit_inliers(src, dst, mask, thresh, min_matches):
    """Final model polish on host f64 (matchers.cpp:657 refits on
    inliers): DLT least squares on the inlier set, re-evaluate, twice.
    Rejects degenerate models whose inlier support is collinear on
    either side (see _spans_2d)."""
    for _ in range(2):
        h = _dlt(src[mask], dst[mask])
        err = np.linalg.norm(_project(h, src) - dst, axis=-1)
        mask = err < thresh
        if mask.sum() < min_matches:
            return None, None
    if not (_spans_2d(src, mask, thresh) and _spans_2d(dst, mask, thresh)):
        return None, None
    return _dlt(src[mask], dst[mask]), mask


def _h4p(s, d):
    """Batched 4-point homography with h33=1: one linear solve per
    hypothesis (degenerate samples yield a singular system -> non-finite
    H -> zero inliers, the lazy-rejection semantics of the host path)."""
    x, y = s[..., 0], s[..., 1]  # [..., 4]
    u, v = d[..., 0], d[..., 1]
    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    r0 = jnp.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    r1 = jnp.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    a = jnp.concatenate([r0, r1], axis=-2)  # [..., 8, 8]
    b = jnp.concatenate([u, v], axis=-1)  # [..., 8]
    h = jnp.linalg.solve(a, b[..., None])[..., 0]
    h = jnp.concatenate([h, jnp.ones_like(h[..., :1])], axis=-1)
    return h.reshape(h.shape[:-1] + (3, 3))


@jax.jit
def _ransac_score_batch(src, dst, valid, samples, thresh):
    """Hypothesis generation + scoring for EVERY pair as one device
    program (VERDICT r2 item 7; the reference runs the pairwise fan-out
    on parallel CPU threads, matchers.cpp:530-555).  src/dst [P, M, 2]
    padded, valid [P, M], samples [P, B, 4].  Returns the best
    hypothesis's inlier mask [P, M] and count [P]."""
    s = jax.vmap(lambda a, i: a[i])(src, samples)  # [P, B, 4, 2]
    d = jax.vmap(lambda a, i: a[i])(dst, samples)
    hs = _h4p(s, d)  # [P, B, 3, 3]
    pts = jnp.concatenate([src, jnp.ones_like(src[..., :1])], -1)
    # HIGHEST: these are pixel coordinates, and TF32's ~3 digits would
    # move a projection by ~1 px at 2000 px, the size of the threshold
    proj = jnp.einsum(
        "pbij,pmj->pbmi", hs, pts, precision=jax.lax.Precision.HIGHEST
    )
    z = proj[..., 2]
    z = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    pp = proj[..., :2] / z[..., None]
    err2 = jnp.sum((pp - dst[:, None]) ** 2, axis=-1)  # [P, B, M]
    inl = (
        (err2 < thresh * thresh)
        & valid[:, None, :]
        & jnp.isfinite(err2)
    )
    counts = inl.sum(axis=-1)  # [P, B]
    best = jnp.argmax(counts, axis=1)
    bmask = jnp.take_along_axis(inl, best[:, None, None], axis=1)[:, 0]
    bcount = jnp.take_along_axis(counts, best[:, None], axis=1)[:, 0]
    return bmask, bcount


def _pairs_from_nn(d12, i12, d21, i21, match_conf):
    """Ratio test both directions + union (host post-processing of the
    batched 2-NN results)."""
    ratio = 1.0 - match_conf
    chosen = set()
    pairs = []
    ok12 = d12[:, 0] < ratio * np.maximum(d12[:, 1], 1e-6)
    for q in np.flatnonzero(ok12):
        pairs.append((q, i12[q, 0]))
        chosen.add((q, int(i12[q, 0])))
    ok21 = d21[:, 0] < ratio * np.maximum(d21[:, 1], 1e-6)
    for q in np.flatnonzero(ok21):
        pair = (int(i21[q, 0]), q)
        if pair not in chosen:
            pairs.append(pair)
    if not pairs:
        return np.zeros((0, 2), np.int32), np.zeros((0,), bool)
    pairs = np.asarray(pairs, dtype=np.int32)
    return pairs, np.ones(len(pairs), dtype=bool)


@jax.jit
def _two_nn_batch(d1s, v1s, d2s, v2s):
    """Batched 2-NN over a stacked pair axis: [P, K, 256] x2 -> the whole
    pairwise fan-out as ONE device program (the reference parallelizes
    this loop over CPU threads, matchers.cpp:530-555; here every pair's
    Hamming matrix is an independent matmul XLA schedules freely)."""
    return jax.vmap(_two_nn)(d1s, v1s, d2s, v2s)


def match_images(
    features,
    match_conf=0.3,
    num_matches_thresh1=6,
    seed=0,
    range_width=None,
):
    """All-pairs matching fan-out (FeaturesMatcher operator(),
    matchers.cpp:530-555 + BestOf2NearestMatcher::match :581-658).

    ``range_width``: only match ordered neighbors |i - j| < range_width
    (BestOf2NearestRangeMatcher, matchers.cpp:667-695) — for sequences
    ordered by capture position, avoids the O(n^2) fan-out.

    Returns dict {(i, j): MatchesInfo} for i<j."""
    n = len(features)
    pair_list = [
        (i, j)
        for i in range(n)
        for j in range(i + 1, n)
        if range_width is None or (j - i) < range_width
    ]
    out = {}
    if not pair_list:
        return out

    # batched 2-NN: one stacked device call for every pair, both
    # directions (pads descriptor counts to the max K)
    kmax = max(np.asarray(f.descriptors).shape[0] for f in features)

    def padk(a, fill=0.0):
        a = np.asarray(a)
        if a.shape[0] == kmax:
            return a
        pad = np.full((kmax - a.shape[0],) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, pad])

    desc = np.stack([padk(f.descriptors) for f in features])
    val = np.stack([padk(np.asarray(f.valid), False) for f in features])
    ii = np.array([p[0] for p in pair_list])
    jj = np.array([p[1] for p in pair_list])
    d12, i12 = _two_nn_batch(desc[ii], val[ii], desc[jj], val[jj])
    d21, i21 = _two_nn_batch(desc[jj], val[jj], desc[ii], val[ii])
    d12, i12, d21, i21 = (np.asarray(a) for a in (d12, i12, d21, i21))

    # correspondence extraction (ratio test, host) per pair, then
    # hypothesis generation + scoring for ALL eligible pairs as ONE
    # device call; only the tiny per-pair inlier refit stays on host
    ransac = []  # (key, src, dst)
    for p, (i, j) in enumerate(pair_list):
        f1, f2 = features[i], features[j]
        pairs, valid = _pairs_from_nn(
            d12[p], i12[p], d21[p], i21[p], match_conf
        )
        mi = MatchesInfo(src_idx=i, dst_idx=j, pairs=pairs, valid=valid)
        out[(i, j)] = mi
        if len(pairs) < max(num_matches_thresh1, 4):
            continue
        k1 = np.asarray(f1.keypoints)
        k2 = np.asarray(f2.keypoints)
        w1, h1 = f1.img_size
        w2, h2 = f2.img_size
        src = k1[pairs[:, 0]] - np.array([w1 * 0.5, h1 * 0.5])
        dst = k2[pairs[:, 1]] - np.array([w2 * 0.5, h2 * 0.5])
        ransac.append(((i, j), src, dst))
    if not ransac:
        return out

    iters, thresh = 1024, 3.0
    mmax = max(len(s) for _, s, _ in ransac)
    rng = np.random.default_rng(seed)
    P = len(ransac)
    src_b = np.zeros((P, mmax, 2), np.float32)
    dst_b = np.zeros((P, mmax, 2), np.float32)
    val_b = np.zeros((P, mmax), bool)
    smp_b = np.zeros((P, iters, 4), np.int32)
    for p, (_, s, d) in enumerate(ransac):
        m = len(s)
        src_b[p, :m] = s
        dst_b[p, :m] = d
        val_b[p, :m] = True
        smp_b[p] = rng.integers(0, m, size=(iters, 4))
    masks, counts = _ransac_score_batch(
        src_b, dst_b, val_b, smp_b, thresh
    )
    masks, counts = np.asarray(masks), np.asarray(counts)

    for p, ((i, j), src, dst) in enumerate(ransac):
        if counts[p] < 4:
            continue
        H, inl = _refit_inliers(
            src, dst, masks[p, : len(src)], thresh, min_matches=4
        )
        if H is None or abs(np.linalg.det(H)) < np.finfo(float).eps:
            continue
        mi = out[(i, j)]
        mi.H = H
        mi.inliers = inl
        mi.num_inliers = int(inl.sum())
        conf = mi.num_inliers / (8 + 0.3 * len(mi.pairs))
        # drop too-close image pairs (matchers.cpp:631)
        mi.confidence = 0.0 if conf > 3.0 else conf
    return out
