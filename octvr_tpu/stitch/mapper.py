"""The online Mapper: one jitted function per template doing the whole
per-frame pipeline

    YUV420P -> RGB -> vignette -> remap gather -> gain compensation
    -> feather / multiband blend -> overlays -> (resize) -> YUV420P

A redesign of the reference's CUDA Mapper (octvr/src/mapper.cpp) for
XLA: no streams, no host round-trips — per-input independence is
expressed as separate ops in one XLA program (XLA schedules them), the
gain solve stays on-device, and every shape/ROI is a compile-time
constant baked from the template.
"""

import math
from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.color import (
    down_cols_matrix,
    merge_nv12,
    merge_yuv420p,
    rgb_planar_to_yuv420p,
    split_nv12,
    split_yuv420p,
    up_cols_matrix,
    yuv420p_to_rgb_planar,
)
from ..ops.remap import pack_planes, remap_apply_packed, remap_plan
from ..ops.resize import resize_bilinear
from ..template.compiler import MapperTemplate
from ..utils.pytree import register_plan
from .blenders import (
    build_feather_plan,
    build_multiband_plan,
    feather_blend,
    gather_dtype,
    multiband_blend,
)
from .gain import build_gain_plan, solve_gains
from .gain_blocks import (
    build_blocks_gain_plan,
    sample_block_lattice,
    solve_block_gains,
    solve_block_lattice,
)

WORKING_MEGAPIX = 0.1  # mapper.cpp:43
# multiband pyramid precision of the Mapper, the ShardedMapper and the
# stream CLI (see Mapper's docstring)
DEFAULT_BLEND_DTYPE = "bfloat16"

__all__ = ["Mapper", "StitchPlan"]


def _pool_pow2(x, s, col_mat=None):
    """[C, H, W] -> [C, H/s, W/s] box mean, s a power of two.  Rows pool
    via log2(s) strided-add halvings; columns pool via ``col_mat``
    ([W, W/s] box-mean matrix) when given, else via strided halvings.
    The matmul runs at HIGHEST precision: these means feed the gain
    solve, and TF32's ~1e-3 relative rounding would be the same size as
    the 1e-3 gain tolerance the sharded engine is held to."""
    if col_mat is not None:
        s0 = s
        while s0 > 1:
            x = (x[:, 0::2, :] + x[:, 1::2, :]) * 0.5
            s0 >>= 1
        return jnp.matmul(x, col_mat, precision=jax.lax.Precision.HIGHEST)
    while s > 1:
        x = (x[:, 0::2, :] + x[:, 1::2, :]) * 0.5
        x = (x[:, :, 0::2] + x[:, :, 1::2]) * 0.5
        s >>= 1
    return x


def _pool_cols_matrix(w, s):
    """[w, w/s] box-mean pooling matrix for _pool_pow2's column step."""
    M = np.zeros((w, w // s), dtype=np.float32)
    cols = np.arange((w // s) * s)
    M[cols, cols // s] = 1.0 / s
    return M


@dataclass
class _InputPlan:
    roi: tuple
    remap: object
    # working-scale image spec: (oy, ox, stride, wh, ww) — stride x
    # stride box means over canvas-aligned blocks of the warped ROI (the
    # reference's 0.1 MP resize, mapper.cpp:235; no second gather needed)
    work_sub: Optional[tuple]
    work_roi: tuple
    vignette: Optional[np.ndarray]  # f32 [H_in, W_in] or None
    mask: np.ndarray  # u8 roi-sized
    pool_cols: object = None  # [ww*s, ww] box-mean matrix
    # yuv420 pipeline extras
    remap_uv: object = None  # half-res chroma gather plan
    vig_half: object = None  # f32 [H_in/2, W_in/2] chroma-grid vignette
    roi_uv: tuple = None  # chroma-grid roi
    mask_half: object = None  # u8 chroma-grid mask (overlay paste)
    # chroma sampling onto the SAME working grid as the luma pool (for
    # the exact RGB-norm gain solve, yuv_mode.yuv_rgb_norm):
    # stride>=2 pools the chroma plane at stride/2 (canvas-aligned);
    # stride==1 gathers nearest chroma rows/cols
    work_sub_uv: tuple = None  # (oy, ox, stride/2, wh, ww) or None
    pool_cols_uv: object = None  # [ww*su, ww] box-mean matrix
    uv_rows: object = None  # i32 [wh] chroma row gather (stride==1)
    uv_cols: object = None  # i32 [ww] chroma col gather (stride==1)


register_plan(
    _InputPlan,
    children=("remap", "vignette", "mask", "pool_cols", "remap_uv",
              "vig_half", "mask_half", "pool_cols_uv", "uv_rows", "uv_cols"),
    static=("roi", "work_sub", "work_roi", "roi_uv", "work_sub_uv"),
)


@dataclass
class StitchPlan:
    canvas_size: tuple  # (W, H)
    out_size: tuple  # final output (W, H) after optional scaling
    inputs: List[_InputPlan] = field(default_factory=list)
    overlays: List[_InputPlan] = field(default_factory=list)
    gain: object = None
    gain_blocks: object = None
    blender: object = None
    blend_kind: str = "none"  # "multiband" | "feather" | "none"
    blender_uv: object = None  # half-res blend plan (yuv420 pipeline)
    chroma_up: dict = field(default_factory=dict)  # width -> upsample matrix
    chroma_down: object = None  # [W, W/2] chroma subsample matrix (output)
    working_scale: float = 1.0
    pipeline: str = "rgb"  # "rgb" | "yuv420"


register_plan(
    StitchPlan,
    children=(
        "inputs",
        "overlays",
        "gain",
        "gain_blocks",
        "blender",
        "blender_uv",
        "chroma_up",
        "chroma_down",
    ),
    static=(
        "canvas_size",
        "out_size",
        "blend_kind",
        "working_scale",
        "pipeline",
    ),
)


class Mapper:
    """blend: >0 multiband blend width, 0 none, <0 feather border
    (mapper.hpp:69-71).  enable_gain: False, True (global pairwise
    gains), or "blocks" (BlocksGainCompensator-style per-block gain
    maps).  blend_dtype: multiband pyramid precision -- "bfloat16"
    (default; the 16-bit analogue of the reference's CV_16S GPU
    pyramids, stitching/src/blenders.cpp:594-736) or "float32".
    pipeline: "rgb", "yuv420" (the YUV420-native path,
    stitch/yuv_mode.py), or "auto" (default): yuv420 whenever the
    camera, canvas and output geometry is even (YUV 4:2:0 is inherently
    even), rgb otherwise.  The rgb + float32 path is the reference the
    defaults are compared against (tests/test_yuv420_product.py,
    tests/test_stitch.py, bench.py::default_path_regression)."""

    def __init__(
        self,
        mt: MapperTemplate,
        in_sizes,
        blend: int = 128,
        enable_gain: bool = True,
        scale_output=None,
        frame_format: str = "yuv420p",
        blend_dtype: str = DEFAULT_BLEND_DTYPE,
        pipeline: str = "auto",
    ):
        assert frame_format in ("yuv420p", "nv12")
        assert pipeline in ("auto", "rgb", "yuv420")
        self.frame_format = frame_format
        n = len(mt.inputs)
        W, H = mt.out_size
        out_size = tuple(scale_output) if scale_output else (W, H)
        even = (
            W % 2 == 0
            and H % 2 == 0
            and out_size[0] % 2 == 0
            and out_size[1] % 2 == 0
            and all(h % 2 == 0 and w % 2 == 0 for h, w in in_sizes)
        )
        if pipeline == "auto":
            pipeline = "yuv420" if even else "rgb"
        yuv = pipeline == "yuv420"
        if yuv:
            # YUV420-native path (see stitch/yuv_mode.py): the 4:2:0
            # layout needs even camera/canvas/output geometry
            assert even, "yuv420 pipeline needs even frame geometry"
        if n == 1:
            blend = 0
            enable_gain = False

        plan = StitchPlan(
            canvas_size=(W, H),
            out_size=out_size,
            pipeline=pipeline,
        )

        working_scale = min(1.0, math.sqrt(WORKING_MEGAPIX * 1e6 / (W * H)))
        # integer canvas stride realizing the working scale: every image
        # samples the same global canvas grid, so overlaps line up.
        # Rounded to the nearest power of two so the grid also aligns
        # with the spatially-sharded path's row bands (band heights are
        # 2^bands multiples; a pow2 stride divides them evenly and every
        # shard sees the same static subsample offsets).
        stride = max(1, int(round(1.0 / working_scale)))
        stride = 1 << max(0, int(round(math.log2(stride))))

        work_masks, work_rois = [], []
        for idx, inp in enumerate(mt.inputs + mt.overlay_inputs):
            is_overlay = idx >= n
            in_h, in_w = in_sizes[idx]
            rx, ry, rw, rh = inp.roi
            rp = remap_plan(inp.map1, inp.map2, in_h, in_w)

            work_sub = None
            wroi = None
            if not is_overlay:
                # working image = stride x stride box means over canvas-
                # aligned blocks (the reference's cv::resize to 0.1 MP,
                # mapper.cpp:235; no second gather needed)
                gx = -(-rx // stride)  # first full block inside the roi
                gy = -(-ry // stride)
                ox, oy = gx * stride - rx, gy * stride - ry
                ww = (rw - ox) // stride
                wh = (rh - oy) // stride
                work_sub = (oy, ox, stride, wh, ww)
                wroi = (gx, gy, ww, wh)
                mb = (inp.mask > 0).astype(np.float32)[
                    oy : oy + wh * stride, ox : ox + ww * stride
                ]
                pooled = mb.reshape(wh, stride, ww, stride).mean(axis=(1, 3))
                # a block counts only when fully covered by the mask
                work_masks.append((pooled > 0.999).astype(np.uint8) * 255)
                work_rois.append(wroi)

            vig = None
            if inp.vignette is not None:
                vig = np.asarray(
                    resize_bilinear(inp.vignette, in_h, in_w)
                ).astype(np.float32)

            pool_cols = None
            if work_sub is not None and stride > 1:
                pool_cols = _pool_cols_matrix(
                    work_sub[4] * stride, stride
                )
            vig_half = None
            roi_uv = None
            mask_half = None
            work_sub_uv = None
            pool_cols_uv = None
            uv_rows = uv_cols = None
            remap_uv = None
            if yuv:
                from .yuv_mode import half_mask, half_maps

                hm1, hm2, roi_uv = half_maps(inp.map1, inp.map2, inp.roi)
                remap_uv = remap_plan(hm1, hm2, in_h // 2, in_w // 2)
                if work_sub is not None:
                    # chroma onto the luma working grid (exact-norm gains)
                    oy, ox, s, wh, ww = work_sub
                    cx0, cy0 = roi_uv[0], roi_uv[1]
                    if s >= 2:
                        su = s // 2
                        work_sub_uv = (
                            (ry + oy) // 2 - cy0,
                            (rx + ox) // 2 - cx0,
                            su,
                            wh,
                            ww,
                        )
                        if su > 1:
                            pool_cols_uv = _pool_cols_matrix(ww * su, su)
                    else:
                        uv_rows = (
                            (ry + oy + np.arange(wh)) // 2 - cy0
                        ).astype(np.int32)
                        uv_cols = (
                            (rx + ox + np.arange(ww)) // 2 - cx0
                        ).astype(np.int32)
                if vig is not None:
                    # chroma-grid vignette (2x2 mean of the luma-grid map)
                    vig_half = (
                        vig.reshape(in_h // 2, 2, in_w // 2, 2)
                        .mean(axis=(1, 3))
                        .astype(np.float32)
                    )
                mask_half = (
                    half_mask(inp.mask, inp.roi) > 0
                ).astype(np.uint8) * 255
            ip = _InputPlan(
                roi=inp.roi,
                remap=rp,
                work_sub=work_sub,
                work_roi=wroi,
                vignette=vig,
                mask=inp.mask,
                pool_cols=pool_cols,
                remap_uv=remap_uv,
                vig_half=vig_half,
                roi_uv=roi_uv,
                mask_half=mask_half,
                work_sub_uv=work_sub_uv,
                pool_cols_uv=pool_cols_uv,
                uv_rows=uv_rows,
                uv_cols=uv_cols,
            )
            (plan.overlays if is_overlay else plan.inputs).append(ip)

        if enable_gain == "blocks":
            plan.gain = build_gain_plan(work_masks, work_rois)  # for sums
            ws_w = -(-W // stride)
            ws_h = -(-H // stride)
            plan.gain_blocks = build_blocks_gain_plan(
                work_masks, work_rois, (ws_w, ws_h)
            )
        elif enable_gain:
            plan.gain = build_gain_plan(work_masks, work_rois)
        plan.working_scale = 1.0 / stride

        for (in_h, in_w) in set(map(tuple, in_sizes)):
            plan.chroma_up[in_w] = up_cols_matrix(in_w // 2)
        plan.chroma_down = down_cols_matrix(plan.out_size[0])

        rois = [inp.roi for inp in mt.inputs]
        if blend > 0:
            num_bands = int(math.ceil(math.log(blend) / math.log(2.0)) - 1.0)
            plan.blender = build_multiband_plan(
                mt.seam_masks, rois, num_bands, (W, H), dtype=blend_dtype
            )
            plan.blend_kind = "multiband"
        elif blend < 0:
            plan.blender = build_feather_plan(
                [i.mask for i in mt.inputs], rois, -blend
            )
            plan.blend_kind = "feather"

        if yuv:
            from .yuv_mode import half_mask

            rois_uv = [ip.roi_uv for ip in plan.inputs]
            if blend > 0:
                seams_uv = [
                    half_mask(sm, i.roi)
                    for sm, i in zip(mt.seam_masks, mt.inputs)
                ]
                plan.blender_uv = build_multiband_plan(
                    seams_uv,
                    rois_uv,
                    max(1, num_bands - 1),
                    (W // 2, H // 2),
                    dtype=blend_dtype,
                )
            elif blend < 0:
                masks_uv = [
                    (half_mask(i.mask, i.roi) > 0).astype(np.uint8) * 255
                    for i in mt.inputs
                ]
                plan.blender_uv = build_feather_plan(
                    masks_uv, rois_uv, max(1, (-blend) // 2)
                )

        self.plan = plan
        self.num_inputs = n

        # the plan's arrays are jit *arguments* (device-resident buffers
        # uploaded once), not constants embedded in the program
        self._plan_dev = jax.device_put(plan)
        self._stitch_auto = jax.jit(
            lambda plan, bufs: self._forward(plan, bufs, None)
        )
        self._stitch_gains = jax.jit(
            lambda plan, bufs, g: self._forward(plan, bufs, g)
        )
        # donated variants (frame-buffer HBM reuse) compile lazily on
        # first stitch(donate=True); see stitch() docstring
        self._stitch_auto_don = None
        self._stitch_gains_don = None
        # B-frame throughput variants compile lazily per B (stitch_batch)
        self._stitch_batch_jits = {}

    # ------------------------------------------------------------ forward

    def _warp_dtype(self, plan, i):
        """gather_dtype for this plan's input i."""
        return gather_dtype(
            plan.blend_kind,
            getattr(plan.blender, "compute_dtype", "float32"),
            i,
            self.num_inputs,
        )

    def _forward(self, plan, yuv_inputs, ext_gains):
        if plan.pipeline == "yuv420":
            return self._forward_yuv(plan, yuv_inputs, ext_gains)
        W, H = plan.canvas_size

        def to_rgb(buf):
            if self.frame_format == "nv12":
                buf = merge_yuv420p(*split_nv12(buf))
            up = plan.chroma_up.get(buf.shape[1])
            return yuv420p_to_rgb_planar(buf, up_cols=up)

        warped = []
        for i, (buf, ip) in enumerate(zip(yuv_inputs, plan.inputs + plan.overlays)):
            rgb = to_rgb(buf)  # [3, H, W] f32 planar
            if ip.vignette is not None:
                rgb = jnp.clip(rgb * jnp.asarray(ip.vignette)[None], 0.0, 255.0)
            warped.append(
                remap_apply_packed(
                    pack_planes(rgb), ip.remap, nc=3,
                    out_dtype=self._warp_dtype(plan, i),
                )
            )

        # working-scale luminance norms straight off the warped images:
        # warped[y, x] already equals the bilinear source lookup at the
        # subsampled coordinate, so a strided slice replaces the
        # reference's extra working-scale remap (mapper.cpp:235 resize)
        work_norms = []
        if plan.gain is not None:
            for w, ip in zip(warped[: self.num_inputs], plan.inputs):
                oy, ox, s, wh, ww = ip.work_sub
                wimg = w[:, oy : oy + wh * s, ox : ox + ww * s].astype(
                    jnp.float32
                )
                wimg = _pool_pow2(wimg, s, col_mat=ip.pool_cols)
                work_norms.append(jnp.sqrt(jnp.sum(wimg * wimg, axis=0)))

        gains = None
        if plan.gain_blocks is not None:
            gmaps = solve_block_gains(
                plan.gain_blocks,
                work_norms,
                out_rois=[ip.roi for ip in plan.inputs],
                scale=plan.working_scale,
            )
            warped = [
                w * gmaps[i][None].astype(w.dtype)
                if i < self.num_inputs
                else w
                for i, w in enumerate(warped)
            ]
        elif plan.gain is not None:
            if ext_gains is None:
                gains = solve_gains(plan.gain, work_norms)
            else:
                gains = ext_gains
            # cast the scalar, not the image: a f32*bf16 promote would
            # silently undo the bf16 path
            warped = [
                w * gains[i].astype(w.dtype) if i < self.num_inputs else w
                for i, w in enumerate(warped)
            ]

        blend_imgs = warped[: self.num_inputs]
        if plan.blend_kind == "multiband":
            canvas = multiband_blend(plan.blender, blend_imgs, (W, H))
        elif plan.blend_kind == "feather":
            canvas = feather_blend(plan.blender, blend_imgs, (W, H))
        else:
            canvas = jnp.zeros((3, H, W), dtype=jnp.float32)
            for img, ip in zip(blend_imgs, plan.inputs):
                x, y, rw, rh = ip.roi
                m = (jnp.asarray(ip.mask) > 0)[None]
                region = canvas[:, y : y + rh, x : x + rw]
                canvas = canvas.at[:, y : y + rh, x : x + rw].set(
                    jnp.where(m, img, region)
                )

        for img, ip in zip(warped[self.num_inputs :], plan.overlays):
            x, y, rw, rh = ip.roi
            m = (jnp.asarray(ip.mask) > 0)[None]
            region = canvas[:, y : y + rh, x : x + rw]
            canvas = canvas.at[:, y : y + rh, x : x + rw].set(
                jnp.where(m, img, region)
            )

        canvas = jnp.clip(canvas, 0.0, 255.0)
        if plan.out_size != plan.canvas_size:
            ow, oh = plan.out_size
            canvas = jnp.stack(
                [
                    resize_bilinear(canvas[c], oh, ow, xp=jnp)
                    for c in range(3)
                ]
            )
        out = rgb_planar_to_yuv420p(canvas, down_cols=plan.chroma_down)
        if self.frame_format == "nv12":
            out = merge_nv12(*split_yuv420p(out))
        if gains is None:
            gains = jnp.ones((self.num_inputs,), dtype=jnp.float32)
        return out, gains

    def _forward_yuv(self, plan, yuv_inputs, ext_gains):
        """YUV420-native per-frame path (see stitch/yuv_mode.py): the
        luma plane gathered at full resolution (nc=1) and U|V packed
        into one plane gathered at half resolution (nc=2), separate Y/UV
        blends, direct packed YUV420P output.  Chroma rides CENTERED
        (U-128, V-128) from the gain stage through the blend — the blend
        weights sum to one where covered and the band normalization
        leaves uncovered pixels at 0, so adding 128 back at the output
        yields neutral chroma exactly where the RGB path yields black."""
        warped_y, warped_uv = [], []
        for i, (buf, ip) in enumerate(zip(yuv_inputs, plan.inputs + plan.overlays)):
            if self.frame_format == "nv12":
                buf = merge_yuv420p(*split_nv12(buf))
            y, u, v = split_yuv420p(buf)
            yf = y.astype(jnp.float32)
            uf = u.astype(jnp.float32)
            vf = v.astype(jnp.float32)
            if ip.vignette is not None:
                yf = jnp.clip(yf * jnp.asarray(ip.vignette), 0.0, 255.0)
                vh = jnp.asarray(ip.vig_half)
                uf = jnp.clip((uf - 128.0) * vh + 128.0, 0.0, 255.0)
                vf = jnp.clip((vf - 128.0) * vh + 128.0, 0.0, 255.0)
            dt = self._warp_dtype(plan, i)
            warped_y.append(
                remap_apply_packed(pack_planes([yf]), ip.remap, nc=1, out_dtype=dt)
            )
            warped_uv.append(
                remap_apply_packed(
                    pack_planes([uf, vf]), ip.remap_uv, nc=2, out_dtype=dt
                )
            )
        return self._postwarp_yuv(plan, warped_y, warped_uv, ext_gains)

    def _postwarp_yuv(self, plan, warped_y, warped_uv, ext_gains):
        """Everything after the gathers: chroma centering, gains,
        blends, overlays, resize, packed output."""
        W, H = plan.canvas_size
        n = self.num_inputs
        # center chroma: covered pixels carry (U-128, V-128); uncovered
        # stay 0 and become neutral 128 at the output stage
        warped_uv = [wuv - jnp.asarray(128.0, wuv.dtype) for wuv in warped_uv]

        # exposure gains from the EXACT elementNorm (gpu_mat.cu:444-485):
        # RGB L2 norm reconstructed from pooled luma + pooled centered
        # chroma on the same working grid (yuv_mode.yuv_rgb_norm) — the
        # chroma plane is already remapped at half res, so this costs a
        # 0.1 MP-grid pool + a few FMAs, not an image upsample
        work_norms = []
        if plan.gain is not None:
            from .yuv_mode import yuv_rgb_norm

            for wy, wuv, ip in zip(
                warped_y[:n], warped_uv[:n], plan.inputs
            ):
                oy, ox, s, wh, ww = ip.work_sub
                yimg = wy[:, oy : oy + wh * s, ox : ox + ww * s].astype(
                    jnp.float32
                )
                yimg = _pool_pow2(yimg, s, col_mat=ip.pool_cols)
                if ip.work_sub_uv is not None:
                    oyu, oxu, su, _, _ = ip.work_sub_uv
                    uvimg = wuv[
                        :, oyu : oyu + wh * su, oxu : oxu + ww * su
                    ].astype(jnp.float32)
                    uvimg = _pool_pow2(uvimg, su, col_mat=ip.pool_cols_uv)
                else:  # stride 1: nearest chroma gather
                    uvimg = wuv.astype(jnp.float32)[
                        :, jnp.asarray(ip.uv_rows)
                    ][:, :, jnp.asarray(ip.uv_cols)]
                work_norms.append(
                    yuv_rgb_norm(yimg[0], uvimg[0], uvimg[1])
                )

        gains = None
        if plan.gain_blocks is not None:
            # one lattice solve, two sample grids: per-pixel gain maps
            # on the luma grid and on the half-resolution chroma grid
            # (chroma px = 2 luma px, so the lattice scale doubles)
            lattice = solve_block_lattice(plan.gain_blocks, work_norms)
            gmaps_y = sample_block_lattice(
                plan.gain_blocks,
                lattice,
                [ip.roi for ip in plan.inputs],
                scale=plan.working_scale,
            )
            gmaps_uv = sample_block_lattice(
                plan.gain_blocks,
                lattice,
                [ip.roi_uv for ip in plan.inputs],
                scale=plan.working_scale * 2.0,
            )
            warped_y = [
                w * gmaps_y[i][None].astype(w.dtype) if i < n else w
                for i, w in enumerate(warped_y)
            ]
            warped_uv = [
                w * gmaps_uv[i][None].astype(w.dtype) if i < n else w
                for i, w in enumerate(warped_uv)
            ]
        elif plan.gain is not None:
            if ext_gains is None:
                gains = solve_gains(plan.gain, work_norms)
            else:
                gains = ext_gains
            # Y scales by g; centered chroma scales by g (exact: YUV is
            # affine in RGB)
            warped_y = [
                w * gains[i].astype(w.dtype) if i < n else w
                for i, w in enumerate(warped_y)
            ]
            warped_uv = [
                w * gains[i].astype(w.dtype) if i < n else w
                for i, w in enumerate(warped_uv)
            ]

        def blend(blender, imgs, size, kind_inputs):
            cw, ch = size
            if plan.blend_kind == "multiband":
                return multiband_blend(blender, imgs, size)
            if plan.blend_kind == "feather":
                return feather_blend(blender, imgs, size)
            canvas = jnp.zeros((imgs[0].shape[0], ch, cw), dtype=jnp.float32)
            for img, (x, y, rw, rh), m in kind_inputs(imgs):
                region = canvas[:, y : y + rh, x : x + rw]
                canvas = canvas.at[:, y : y + rh, x : x + rw].set(
                    jnp.where(m, img, region)
                )
            return canvas

        def y_inputs(imgs):
            for img, ip in zip(imgs, plan.inputs):
                yield img, ip.roi, (jnp.asarray(ip.mask) > 0)[None]

        def uv_inputs(imgs):
            for img, ip in zip(imgs, plan.inputs):
                m = (jnp.asarray(ip.mask_half) > 0)[None]
                yield img, ip.roi_uv, m

        y_canvas = blend(plan.blender, warped_y[:n], (W, H), y_inputs)
        uv_canvas = blend(
            plan.blender_uv, warped_uv[:n], (W // 2, H // 2), uv_inputs
        )

        # overlay paste (mapper.cpp:279-282 semantics), Y and UV planes
        for wy, wuv, ip in zip(
            warped_y[n:], warped_uv[n:], plan.overlays
        ):
            x, y, rw, rh = ip.roi
            m = (jnp.asarray(ip.mask) > 0)[None]
            region = y_canvas[:, y : y + rh, x : x + rw]
            y_canvas = y_canvas.at[:, y : y + rh, x : x + rw].set(
                jnp.where(m, wy.astype(y_canvas.dtype), region)
            )
            cx, cy, cw_, ch_ = ip.roi_uv
            mh = (jnp.asarray(ip.mask_half) > 0)[None]
            region = uv_canvas[:, cy : cy + ch_, cx : cx + cw_]
            uv_canvas = uv_canvas.at[:, cy : cy + ch_, cx : cx + cw_].set(
                jnp.where(mh, wuv.astype(uv_canvas.dtype), region)
            )

        yf = y_canvas[0].astype(jnp.float32)
        uvf = uv_canvas.astype(jnp.float32) + 128.0
        if plan.out_size != plan.canvas_size:
            # output resize in the native planes (mapper.cpp:285-311's
            # out_size semantics): Y at full res, chroma at half res
            ow, oh = plan.out_size
            yf = resize_bilinear(yf, oh, ow, xp=jnp)
            uvf = jnp.stack(
                [
                    resize_bilinear(uvf[c], oh // 2, ow // 2, xp=jnp)
                    for c in range(2)
                ]
            )
        y8 = jnp.clip(jnp.round(yf), 0, 255).astype(jnp.uint8)
        u8 = jnp.clip(jnp.round(uvf[0]), 0, 255).astype(jnp.uint8)
        v8 = jnp.clip(jnp.round(uvf[1]), 0, 255).astype(jnp.uint8)
        out = merge_yuv420p(y8, u8, v8)
        if self.frame_format == "nv12":
            out = merge_nv12(y8, u8, v8)
        if gains is None:
            gains = jnp.ones((n,), dtype=jnp.float32)
        return out, gains

    def _forward_batch(self, plan, yuv_inputs, ext_gains):
        """B-frame forward: the per-frame forward statically unrolled
        (one program per B amortizes dispatch only)."""
        B = yuv_inputs[0].shape[0]
        outs, gains = [], []
        for b in range(B):
            eg = None if ext_gains is None else ext_gains[b]
            out, g = self._forward(plan, [f[b] for f in yuv_inputs], eg)
            outs.append(out)
            gains.append(g)
        return jnp.stack(outs), jnp.stack(gains)

    # ------------------------------------------------------------- public

    def stitch_batch(self, yuv_inputs, gains=None, donate=False):
        """Stitch B frame sets in ONE jitted program (the pipeline's
        mesh-'data' batch on one device): yuv_inputs is a per-input list
        of [B, Hi*3/2, Wi] u8 arrays.  ``gains``: optional [B, n]
        injection (async.cpp:75-91 sharing).  Returns
        (out [B, Ho*3/2, Wo] u8, gains [B, n] f32)."""
        bufs = tuple(jnp.asarray(b) for b in yuv_inputs)
        B = bufs[0].shape[0]
        key = (B, gains is not None, donate)
        fn = self._stitch_batch_jits.get(key)
        if fn is None:
            don = (1,) if donate else ()
            if gains is None:
                fn = jax.jit(
                    lambda plan, bufs: self._forward_batch(plan, bufs, None),
                    donate_argnums=don,
                )
            else:
                fn = jax.jit(
                    lambda plan, bufs, g: self._forward_batch(plan, bufs, g),
                    donate_argnums=don,
                )
            self._stitch_batch_jits[key] = fn
        if gains is None:
            return fn(self._plan_dev, bufs)
        return fn(
            self._plan_dev, bufs, jnp.asarray(gains, dtype=jnp.float32)
        )

    def stitch(self, yuv_inputs, gains=None, donate=False):
        """yuv_inputs: list of [Hi*3/2, Wi] uint8 arrays (packed YUV420P).
        Returns (yuv_out [Ho*3/2, Wo] uint8, gains [n] f32).  Pass
        ``gains`` to reuse exposure gains from another output (the
        async.cpp:75-91 gain-sharing semantics).  ``donate=True`` donates
        the frame buffers to XLA (the pinned-HostMem reuse analogue,
        async.cpp:263-309): their HBM is recycled for the stitch's
        temporaries, but the caller must NOT touch them afterwards —
        streaming callers that upload a fresh frame set per call
        (runtime/pipeline.py) opt in; the donated jits compile lazily so
        non-streaming users never pay the extra compile."""
        bufs = tuple(jnp.asarray(b) for b in yuv_inputs)
        if gains is None:
            if donate:
                if self._stitch_auto_don is None:
                    self._stitch_auto_don = jax.jit(
                        lambda plan, bufs: self._forward(plan, bufs, None),
                        donate_argnums=(1,),
                    )
                return self._stitch_auto_don(self._plan_dev, bufs)
            return self._stitch_auto(self._plan_dev, bufs)
        g = jnp.asarray(gains, dtype=jnp.float32)
        if donate:
            if self._stitch_gains_don is None:
                self._stitch_gains_don = jax.jit(
                    lambda plan, bufs, g: self._forward(plan, bufs, g),
                    donate_argnums=(1,),
                )
            return self._stitch_gains_don(self._plan_dev, bufs, g)
        return self._stitch_gains(self._plan_dev, bufs, g)


class FastMapper(Mapper):
    """The mobile/OpenCL profile of the reference (vr::FastMapper,
    mapper_fast.cpp): NV12 frames in and out, feather-only blending, no
    exposure compensation, full-frame ROIs.  Same template format."""

    def __init__(self, mt, in_sizes, border: int = 8, **kw):
        super().__init__(
            mt,
            in_sizes,
            blend=-abs(border),
            enable_gain=False,
            frame_format="nv12",
            **kw,
        )

    def stitch_nv12(self, nv12_inputs):
        out, _ = self.stitch(nv12_inputs)
        return out
