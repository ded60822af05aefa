"""Block-wise exposure compensation — the BlocksGainCompensator role
(stitching/src/exposure_compensate.cpp:330-438): gains are solved per
canvas block and bilinearly interpolated into smooth per-pixel gain
maps, correcting spatially-varying exposure (vignetting remnants,
lens flare).

Array design: the per-block pairwise systems are assembled from
block-reduced masked sums (a reshape-reduction, no gather) and solved as
ONE batched jnp.linalg.solve over all blocks (vmap over the block axis);
the gain maps are a bilinear upsample of the [nbY, nbX] gain lattice.
"""

from dataclasses import dataclass
from typing import List

import jax.numpy as jnp
import numpy as np

from ..utils.pytree import register_plan
from .gain import ALPHA, BETA

__all__ = [
    "BlocksGainPlan",
    "build_blocks_gain_plan",
    "solve_block_gains",
    "solve_block_lattice",
    "assemble_and_solve_lattice",
    "sample_block_lattice",
]


@dataclass
class BlocksGainPlan:
    num_images: int
    block: int  # block size in working-scale pixels
    nby: int
    nbx: int
    canvas: tuple  # working-scale canvas (Hc, Wc), padded to block grid
    rois: tuple  # per image working-scale roi (x, y, w, h)
    # constants
    cover: object  # f32 [n, Hc, Wc] mask per image (canvas frame)
    N: object  # f32 [B, n, n] per-block pair counts (>=1)
    A_static: object  # f32 [B, n, n]
    b: object  # f32 [B, n]


register_plan(
    BlocksGainPlan,
    children=("cover", "N", "A_static", "b"),
    static=("num_images", "block", "nby", "nbx", "canvas", "rois"),
)


def build_blocks_gain_plan(masks: List[np.ndarray], rois, canvas_size, block=32):
    """masks: working-scale uint8 per image (roi-sized); rois: working
    scale (x, y, w, h); canvas_size: working scale (W, H)."""
    W, H = canvas_size
    n = len(masks)
    nby = -(-H // block)
    nbx = -(-W // block)
    Hc, Wc = nby * block, nbx * block

    cover = np.zeros((n, Hc, Wc), dtype=np.float32)
    for i, (m, (x, y, w, h)) in enumerate(zip(masks, rois)):
        cover[i, y : y + h, x : x + w] = (np.asarray(m) > 0).astype(
            np.float32
        )

    def block_sum(a):
        return a.reshape(*a.shape[:-2], nby, block, nbx, block).sum(
            axis=(-3, -1)
        )

    B = nby * nbx
    N = np.ones((B, n, n), dtype=np.float32)
    for i in range(n):
        Nii = block_sum(cover[i]).reshape(B)
        N[:, i, i] = np.maximum(Nii, 1.0)
        for j in range(i + 1, n):
            Nij = block_sum(cover[i] * cover[j]).reshape(B)
            N[:, i, j] = N[:, j, i] = np.maximum(Nij, 1.0)

    b_vec = BETA * N.sum(axis=2)  # [B, n]
    A_static = BETA * np.einsum("bij,ik->bik", N, np.eye(n, dtype=np.float32))
    # A_static diag: beta * sum_j N(i, j)
    A_static = np.zeros((B, n, n), dtype=np.float32)
    for i in range(n):
        A_static[:, i, i] = BETA * N[:, i].sum(axis=1)

    return BlocksGainPlan(
        num_images=n,
        block=block,
        nby=nby,
        nbx=nbx,
        canvas=(Hc, Wc),
        rois=tuple(tuple(r) for r in rois),
        cover=cover,
        N=N,
        A_static=A_static,
        b=b_vec,
    )


def solve_block_gains(plan: BlocksGainPlan, norm_images, out_rois=None, scale=1.0):
    """norm_images: list of f32 [rh_i, rw_i] working-scale luminance
    norms (roi frame).  Returns per-image gain maps from bilinearly
    upsampled block gains; ``out_rois``/``scale`` sample the lattice at
    full-resolution rois (full-res px * scale = working px)."""
    lattice = solve_block_lattice(plan, norm_images)
    rois_out = plan.rois if out_rois is None else out_rois
    return sample_block_lattice(plan, lattice, rois_out, scale)


def solve_block_lattice(plan: BlocksGainPlan, norm_images):
    """Assemble and solve the per-block pairwise systems; returns the
    gain lattice [nby, nbx, n].  Split from the sampling step so one
    solve can feed multiple sample grids (e.g. the yuv420 pipeline's
    luma and half-resolution chroma planes)."""
    n = plan.num_images
    Hc, Wc = plan.canvas
    block, nby, nbx = plan.block, plan.nby, plan.nbx
    B = nby * nbx

    canvas_norm = jnp.zeros((n, Hc, Wc), dtype=jnp.float32)
    for i, (nm, (x, y, w, h)) in enumerate(zip(norm_images, plan.rois)):
        canvas_norm = canvas_norm.at[i, y : y + h, x : x + w].set(nm)
    canvas_norm = canvas_norm * plan.cover

    def block_sum(a):
        return a.reshape(*a.shape[:-2], nby, block, nbx, block).sum(
            axis=(-3, -1)
        )

    # I[b, i, j] = mean of norm_i over the (i, j) overlap within block b
    I = jnp.zeros((B, n, n), dtype=jnp.float32)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            s = block_sum(canvas_norm[i] * plan.cover[j]).reshape(B)
            I = I.at[:, i, j].set(s / plan.N[:, i, j])

    return assemble_and_solve_lattice(plan, I)


def assemble_and_solve_lattice(plan: BlocksGainPlan, I):
    """Per-block BL07 system assembly + batched solve from the overlap
    means I [B, n, n]; split out so the spatially-sharded path can psum
    partial block sums into I first (parallel/sharded.py)."""
    n = plan.num_images
    nby, nbx = plan.nby, plan.nbx
    Nf = jnp.asarray(plan.N)
    off = 1.0 - jnp.eye(n, dtype=jnp.float32)[None]
    diag_dyn = jnp.sum(2.0 * ALPHA * I * I * Nf * off, axis=2)
    A = jnp.asarray(plan.A_static) + _diag_embed(diag_dyn) - (
        2.0 * ALPHA * I * jnp.swapaxes(I, 1, 2) * Nf * off
    )
    gains = jnp.linalg.solve(A, jnp.asarray(plan.b)[..., None])[..., 0]  # [B, n]
    return gains.reshape(nby, nbx, n)


def sample_block_lattice(plan: BlocksGainPlan, lattice, rois_out, scale=1.0):
    """Bilinear upsample of the block gain lattice to per-pixel maps at
    the given rois; ``scale`` converts roi pixels to working-scale
    pixels (roi px * scale = working px)."""
    block, nby, nbx = plan.block, plan.nby, plan.nbx
    maps = []
    for i, (x, y, w, h) in enumerate(rois_out):
        ys = ((jnp.arange(y, y + h) + 0.5) * scale) / block - 0.5
        xs = ((jnp.arange(x, x + w) + 0.5) * scale) / block - 0.5
        y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, nby - 1)
        x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, nbx - 1)
        y1 = jnp.minimum(y0 + 1, nby - 1)
        x1 = jnp.minimum(x0 + 1, nbx - 1)
        fy = jnp.clip(ys - y0, 0.0, 1.0)[:, None]
        fx = jnp.clip(xs - x0, 0.0, 1.0)[None, :]
        g = lattice[..., i]
        top = g[y0][:, x0] * (1 - fx) + g[y0][:, x1] * fx
        bot = g[y1][:, x0] * (1 - fx) + g[y1][:, x1] * fx
        maps.append(top * (1 - fy) + bot * fy)
    return maps


def _diag_embed(d):
    """[B, n] -> [B, n, n] diagonal matrices."""
    n = d.shape[-1]
    return d[..., None] * jnp.eye(n, dtype=d.dtype)[None]
