"""The remap gather — the per-frame hot op.

The maps are static per template, so all bilinear arithmetic (neighbour
indices and weights) is precomputed offline into a ``RemapPlan``; the
online op is four flat gathers plus a multiply-add per output pixel,
which XLA fuses into one pass over the output.  This replaces the
reference's texture-unit kernel (cudawarping/src/cuda/fast_remap.cu:
19-56: normalized coords, hardware bilinear, negative map -> zero fill).

Sources are gathered byte-packed: ``pack_planes`` puts up to four 8-bit
channels into one int32, so one gather per tap serves every channel
(packed RGB, the luma plane alone, or U|V at half resolution).
Quantizing to 8 bits before the gather matches the reference, which
remaps 8-bit RGBA (fast_remap.cu:19).  Images flow planar [C, H, W].
"""

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..utils.pytree import register_plan

__all__ = [
    "RemapPlan",
    "pack_planes",
    "remap_apply",
    "remap_apply_packed",
    "remap_plan",
    "stack_remap_plans",
]


@dataclass(frozen=True)
class RemapPlan:
    """Precomputed gather indices/weights for one (map, input-size) pair.

    idx:  int32 [..., 4, rh*rw]  flat indices into the input plane (y*W + x)
    w:    f32   [..., 4, rh*rw]  bilinear weights (0 where the map is invalid)
    out_shape: (rh, rw)
    in_shape:  (H, W)

    The optional leading axis carries per-shard plans of one shape
    (``stack_remap_plans``); the apply functions take one plan.
    """

    idx: object
    w: object
    out_shape: tuple
    in_shape: tuple


register_plan(RemapPlan, children=("idx", "w"), static=("out_shape", "in_shape"))


def remap_plan(map1: np.ndarray, map2: np.ndarray, in_h: int, in_w: int) -> RemapPlan:
    """Build the gather plan from normalized maps (f32 [rh, rw], -1 where
    invalid).  Sampling matches the reference texture path: pixel coords
    px = mapx * W - 0.5 with clamp-to-edge."""
    rh, rw = map1.shape
    px = map1.astype(np.float64) * in_w - 0.5
    py = map2.astype(np.float64) * in_h - 0.5
    invalid = map1 < 0

    x0 = np.floor(px)
    y0 = np.floor(py)
    fx = (px - x0).astype(np.float32)
    fy = (py - y0).astype(np.float32)
    # both taps clamp to the edge independently (texture clamp mode)
    x1 = np.clip(x0 + 1, 0, in_w - 1).astype(np.int32)
    y1 = np.clip(y0 + 1, 0, in_h - 1).astype(np.int32)
    x0 = np.clip(x0, 0, in_w - 1).astype(np.int32)
    y0 = np.clip(y0, 0, in_h - 1).astype(np.int32)

    idx = np.stack(
        [
            y0 * in_w + x0,
            y0 * in_w + x1,
            y1 * in_w + x0,
            y1 * in_w + x1,
        ]
    ).reshape(4, -1)
    w = np.stack(
        [
            (1 - fx) * (1 - fy),
            fx * (1 - fy),
            (1 - fx) * fy,
            fx * fy,
        ]
    ).reshape(4, -1)
    w[:, invalid.reshape(-1)] = 0.0
    idx[:, invalid.reshape(-1)] = 0
    return RemapPlan(
        idx=idx, w=w.astype(np.float32), out_shape=(rh, rw), in_shape=(in_h, in_w)
    )


def stack_remap_plans(plans):
    """Stack per-shard plans of one output and input shape onto a leading
    axis (the sharded engine's 'space' axis)."""
    p0 = plans[0]
    for p in plans[1:]:
        if (p.out_shape, p.in_shape) != (p0.out_shape, p0.in_shape):
            raise ValueError(
                "stacked remap plans must share out_shape and in_shape: "
                f"{(p.out_shape, p.in_shape)} != {(p0.out_shape, p0.in_shape)}"
            )
    return RemapPlan(
        idx=np.stack([p.idx for p in plans]),
        w=np.stack([p.w for p in plans]),
        out_shape=p0.out_shape,
        in_shape=p0.in_shape,
    )


def remap_apply(img, plan: RemapPlan):
    """img: f32 [C, H, W] -> warped f32 [C, rh, rw].

    Invalid map positions produce exact 0 (fill_zero semantics of
    fast_remap.cu:31-35).  Generic float path; the stitch pipelines
    gather byte-packed sources through ``remap_apply_packed``."""
    c = img.shape[0]
    flat = img.reshape(c, -1)
    idx = jnp.asarray(plan.idx)
    w = jnp.asarray(plan.w)
    out = jnp.zeros((c, idx.shape[1]), dtype=img.dtype)
    for k in range(4):
        out = out + jnp.take(flat, idx[k], axis=1) * w[k][None, :]
    return out.reshape(c, *plan.out_shape)


def pack_planes(planes):
    """8-bit channel planes (a sequence, or a [C, H, W] array, values in
    [0, 255]) -> int32 [H, W] with plane c in byte c (low byte first)."""
    packed = None
    for c, p in enumerate(planes):
        q = jnp.clip(jnp.round(p), 0, 255).astype(jnp.int32)
        packed = q if packed is None else packed | (q << (8 * c))
    return packed


def remap_apply_packed(packed, plan: RemapPlan, nc: int = 3, out_dtype="float32"):
    """packed: int32 [H, W] or [H*W] with ``nc`` byte channels (see
    ``pack_planes``) -> warped [nc, rh, rw] in ``out_dtype``.

    The four taps accumulate in float32; only the result is cast, so a
    bfloat16 consumer (the multiband-bf16 blend) takes its operand
    straight from the gather."""
    flat = packed.reshape(-1)
    idx = jnp.asarray(plan.idx)
    w = jnp.asarray(plan.w)
    out = None
    for k in range(4):
        g = jnp.take(flat, idx[k], mode="clip")
        chans = jnp.stack([(g >> (8 * c)) & 0xFF for c in range(nc)])
        t = chans.astype(jnp.float32) * w[k][None, :]
        out = t if out is None else out + t
    return out.astype(out_dtype).reshape(nc, *plan.out_shape)
