"""Color-space conversions for the online path (jax, jit-friendly).

Replaces the reference's NPP conversions (cudaimgproc/src/color.cpp:
cvtYUV420PtoRGBA32 / cvtRGB24toYUV420P) and the UYVY 4:2:2 split/merge
kernels (cudaimgproc/src/cuda/uyvy.cu).

YUV matrices: full-range BT.601 (JPEG), matching NPP's YUV420 family.

Frame layout (packed YUV420P, mapper.hpp:75-83): one [H*3/2, W] uint8
buffer; Y is the top HxW, U is rows [H, H*3/2) cols [0, W/2), V is rows
[H, H*3/2) cols [W/2, W).
"""

import jax
import jax.numpy as jnp

__all__ = [
    "yuv420p_to_rgb_planar",
    "rgb_planar_to_yuv420p",
    "split_yuv420p",
    "merge_yuv420p",
    "yuv420p_to_rgb",
    "rgb_to_yuv420p",
    "split_uyvy",
    "merge_uyvy",
    "uyvy_to_yuv420p",
]


def split_yuv420p(buf):
    """[H*3/2, W] packed -> (Y [H,W], U [H/2,W/2], V [H/2,W/2])."""
    h = buf.shape[0] * 2 // 3
    w = buf.shape[1]
    y = buf[:h]
    u = buf[h:, : w // 2]
    v = buf[h:, w // 2 :]
    return y, u, v


def merge_yuv420p(y, u, v):
    bottom = jnp.concatenate([u, v], axis=1)
    return jnp.concatenate([y, bottom], axis=0)


def _upsample2(c):
    """Nearest 2x chroma upsample [h,w] -> [2h,2w]."""
    return jnp.repeat(jnp.repeat(c, 2, axis=0), 2, axis=1)


def up_cols_matrix(w_half):
    """[w_half, 2*w_half] nearest column-duplication matrix (bit-exact
    equivalent of a column repeat).  Pass the result as ``up_cols``."""
    import numpy as np

    R = np.zeros((w_half, 2 * w_half), dtype=np.float32)
    R[np.arange(2 * w_half) // 2, np.arange(2 * w_half)] = 1.0
    return R


def yuv420p_to_rgb_planar(buf, dtype=jnp.float32, up_cols=None):
    """Packed YUV420P uint8 -> planar RGB float [3, H, W] in [0, 255].
    Planar-native: no [H, W, 3] intermediate.  ``up_cols`` (from
    up_cols_matrix) does the chroma column upsample as a matmul.  Its
    operands are integers in [-128, 127] and a 0/1 matrix with one
    nonzero per column, exact in TF32 and bf16 alike, so the default
    precision is bit-exact."""
    y, u, v = split_yuv420p(buf)
    yf = y.astype(dtype)
    if up_cols is None:
        uf = _upsample2(u).astype(dtype) - 128.0
        vf = _upsample2(v).astype(dtype) - 128.0
    else:
        def up(c):
            rows = jnp.repeat(c.astype(dtype), 2, axis=0) - 128.0
            return jnp.matmul(rows, up_cols, precision=jax.lax.Precision.DEFAULT)

        uf = up(u)
        vf = up(v)
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    return jnp.clip(jnp.stack([r, g, b], axis=0), 0.0, 255.0)


def yuv420p_to_rgb(buf, dtype=jnp.float32):
    """Packed YUV420P uint8 -> RGB float [H, W, 3] in [0, 255]."""
    return jnp.moveaxis(yuv420p_to_rgb_planar(buf, dtype), 0, -1)


def _box2(c):
    """2x2 box average via strided slices."""
    cr = (c[0::2] + c[1::2]) * 0.5
    return (cr[:, 0::2] + cr[:, 1::2]) * 0.5


def down_cols_matrix(w):
    """[w, w/2] column 2x box-mean matrix.  Pass the result as
    ``down_cols``."""
    import numpy as np

    M = np.zeros((w, w // 2), dtype=np.float32)
    M[np.arange(w), np.arange(w) // 2] = 0.5
    return M


def rgb_planar_to_yuv420p(rgb, down_cols=None):
    """Planar RGB float [3, H, W] in [0,255] -> packed YUV420P uint8
    [H*3/2, W].  Chroma box-averaged 2x2 before subsampling.
    ``down_cols`` (from down_cols_matrix) does the chroma column
    subsample as a matmul at HIGHEST precision: its operands are
    fractional, and TF32 rounding (~0.1 at 255) would flip the rounding
    of output chroma bytes."""
    r, g, b = rgb[0], rgb[1], rgb[2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    if down_cols is None:
        sub = _box2
    else:
        def sub(c):
            return jnp.matmul(
                (c[0::2] + c[1::2]) * 0.5,
                down_cols,
                precision=jax.lax.Precision.HIGHEST,
            )

    yq = jnp.clip(jnp.round(y), 0, 255).astype(jnp.uint8)
    uq = jnp.clip(jnp.round(sub(u)), 0, 255).astype(jnp.uint8)
    vq = jnp.clip(jnp.round(sub(v)), 0, 255).astype(jnp.uint8)
    return merge_yuv420p(yq, uq, vq)


def rgb_to_yuv420p(rgb):
    """RGB float [H, W, 3] in [0,255] -> packed YUV420P uint8 [H*3/2, W].
    Chroma is box-averaged 2x2 before subsampling."""
    r = rgb[..., 0]
    g = rgb[..., 1]
    b = rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    sub = _box2

    yq = jnp.clip(jnp.round(y), 0, 255).astype(jnp.uint8)
    uq = jnp.clip(jnp.round(sub(u)), 0, 255).astype(jnp.uint8)
    vq = jnp.clip(jnp.round(sub(v)), 0, 255).astype(jnp.uint8)
    return merge_yuv420p(yq, uq, vq)


def split_uyvy(buf):
    """Packed UYVY 4:2:2 [H, W, 2] or [H, W*2] uint8 -> (Y [H,W],
    U [H,W/2], V [H,W/2]) (DeckLink SDI capture layout, uyvy.cu:17-30)."""
    if buf.ndim == 2:
        buf = buf.reshape(buf.shape[0], buf.shape[1] // 2, 2)
    # byte stream per 2 px: U0 Y0 V0 Y1
    quads = buf.reshape(buf.shape[0], -1, 4)
    u = quads[..., 0]
    y = jnp.stack([quads[..., 1], quads[..., 3]], axis=-1).reshape(
        buf.shape[0], -1
    )
    v = quads[..., 2]
    return y, u, v


def merge_uyvy(y, u, v):
    h, w = y.shape
    y2 = y.reshape(h, w // 2, 2)
    quads = jnp.stack([u, y2[..., 0], v, y2[..., 1]], axis=-1)
    return quads.reshape(h, w * 2)


def uyvy_to_yuv420p(buf):
    """Packed UYVY 4:2:2 ([H, W*2] or [H, W, 2] uint8, the DeckLink SDI
    capture layout) -> packed YUV420P [H*3/2, W]: split per uyvy.cu
    semantics, then box-average chroma row pairs down to 4:2:0."""
    y, u, v = split_uyvy(buf)

    def rows2(c):
        ci = c.astype(jnp.int32)
        return ((ci[0::2] + ci[1::2] + 1) >> 1).astype(jnp.uint8)

    return merge_yuv420p(y, rows2(u), rows2(v))


def split_nv12(buf):
    """NV12 [H*3/2, W] packed -> (Y [H,W], U [H/2,W/2], V [H/2,W/2]);
    bottom block is interleaved UVUV rows (the FastMapper mobile layout,
    mapper_fast.cpp:153-176)."""
    h = buf.shape[0] * 2 // 3
    y = buf[:h]
    uv = buf[h:].reshape(h // 2, -1, 2)
    return y, uv[..., 0], uv[..., 1]


def merge_nv12(y, u, v):
    h, w = y.shape
    uv = jnp.stack([u, v], axis=-1).reshape(h // 2, w)
    return jnp.concatenate([y, uv], axis=0)


def nv12_to_rgb(buf, dtype=jnp.float32):
    y, u, v = split_nv12(buf)
    return yuv420p_to_rgb(merge_yuv420p(y, u, v), dtype)


def rgb_to_nv12(rgb):
    buf = rgb_to_yuv420p(rgb)
    y, u, v = split_yuv420p(buf)
    return merge_nv12(y, u, v)
