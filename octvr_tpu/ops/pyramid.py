"""Gaussian/Laplacian pyramid ops (XLA convolutions).

Replaces cuda::fastPyrDown / cuda::pyrUp (cudawarping): 5-tap binomial
kernel [1,4,6,4,1]/16, separable, reflect-101 borders, stride-2 down /
dilation-2 up (x4 gain).  Operates on planar [C, H, W] float arrays.
"""

import jax.numpy as jnp
from jax import lax
import numpy as np

_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0

__all__ = ["pyr_down", "pyr_up", "gaussian_pyramid", "laplacian_merge"]


def _sep_conv(img, kv, kh, stride=(1, 1), lhs_dilation=(1, 1), pad=None):
    """Depthwise separable conv on [C, H, W] via two 1-D convs."""
    c = img.shape[0]
    x = img[None]  # NCHW with N=1
    kv4 = jnp.broadcast_to(jnp.asarray(kv).reshape(1, 1, -1, 1), (c, 1, len(kv), 1))
    kh4 = jnp.broadcast_to(jnp.asarray(kh).reshape(1, 1, 1, -1), (c, 1, 1, len(kh)))
    dn = lax.conv_dimension_numbers(x.shape, kv4.shape, ("NCHW", "OIHW", "NCHW"))
    x = lax.conv_general_dilated(
        x,
        kv4,
        window_strides=(stride[0], 1),
        padding=[pad[0], (0, 0)],
        lhs_dilation=(lhs_dilation[0], 1),
        dimension_numbers=dn,
        feature_group_count=c,
    )
    x = lax.conv_general_dilated(
        x,
        kh4,
        window_strides=(1, stride[1]),
        padding=[(0, 0), pad[1]],
        lhs_dilation=(1, lhs_dilation[1]),
        dimension_numbers=dn,
        feature_group_count=c,
    )
    return x[0]


def _reflect101(img, pad_h, pad_w):
    return jnp.pad(img, ((0, 0), (pad_h, pad_h), (pad_w, pad_w)), mode="reflect")


def pyr_down(img):
    """[C, H, W] -> [C, ceil(H/2), ceil(W/2)] (border reflect-101)."""
    x = _reflect101(img, 2, 2)
    return _sep_conv(x, _K, _K, stride=(2, 2), pad=((0, 0), (0, 0)))


def pyr_up(img):
    """[C, h, w] -> [C, 2h, 2w]: zero-stuffed dilation + 4x-gain filter."""
    k = _K * 2.0
    return _sep_conv(
        img, k, k, lhs_dilation=(2, 2), pad=((2, 3), (2, 3))
    )


def gaussian_pyramid(img, levels):
    """[img, down(img), down^2(img), ...] with ``levels+1`` entries."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def laplacian_merge(dst_pyr):
    """Collapse a Laplacian pyramid (list coarse->...  actually index 0 is
    finest): acc = up(L[i+1]) + L[i] from the top down."""
    acc = dst_pyr[-1]
    for i in range(len(dst_pyr) - 2, -1, -1):
        acc = pyr_up(acc) + dst_pyr[i]
    return acc


# ---------------------------------------------------------- matmul path
#
# The blends express the separable 5-tap filter as two dense banded
# matmuls, with the banded matrices built once per distinct axis length
# at plan time.  Both passes take their operands in the input's dtype
# and accumulate in float32.  A float32 blend is the precise reference
# path: its matmuls run at HIGHEST, because TF32's ~1e-3 relative
# rounding (~0.25 at 255 per level) would show in its output.  A
# bfloat16 blend (the explicit low-precision choice) rounds the first
# pass's float32 result back to bfloat16 before the second, so both
# passes are bf16 x bf16 products, which HIGHEST leaves exact.

_HI = lax.Precision.HIGHEST


def down_matrix(n: int) -> np.ndarray:
    """[n//2, n]: rows are the 5-tap kernel at stride 2 with reflect-101
    boundary folding (matches pyr_down exactly)."""
    K = np.zeros((n // 2, n), dtype=np.float32)
    w = np.array([1, 4, 6, 4, 1], dtype=np.float32) / 16.0
    for i in range(n // 2):
        for k in range(5):
            j = 2 * i + k - 2
            if j < 0:
                j = -j
            if j >= n:
                j = 2 * (n - 1) - j
            K[i, j] += w[k]
    return K


def up_matrix(n: int) -> np.ndarray:
    """[2n, n]: zero-stuffed upsample + 5-tap (x2 gain), zero boundary
    (matches pyr_up exactly)."""
    K = np.zeros((2 * n, n), dtype=np.float32)
    w = np.array([1, 4, 6, 4, 1], dtype=np.float32) * 2.0 / 16.0
    for o in range(2 * n):
        for k in range(5):
            j = o + k - 2
            if 0 <= j < 2 * n and j % 2 == 0:
                K[o, j // 2] += w[k]
    return K


def _sep_mm(x, kv, kh):
    v = jnp.einsum(
        "oh,chw->cow", kv, x, preferred_element_type=jnp.float32, precision=_HI
    )
    return jnp.einsum(
        "pw,cow->cop",
        kh,
        v.astype(x.dtype),
        preferred_element_type=jnp.float32,
        precision=_HI,
    )


def pyr_down_mm(x, kv, kh):
    """[C, H, W] -> [C, H/2, W/2] via two banded matmuls.
    kv: [H/2, H], kh: [W/2, W]."""
    return _sep_mm(x, kv, kh)


def pyr_up_mm(x, kv, kh):
    """[C, h, w] -> [C, 2h, 2w].  kv: [2h, h], kh: [2w, w]."""
    return _sep_mm(x, kv, kh)
