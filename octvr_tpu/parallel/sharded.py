"""Multi-device sharded stitching — the full product on a device mesh.

A 2-D device mesh ``('data', 'space')`` (SURVEY.md §2.5/§5):

* ``data``: frame-level data parallelism (each device stitches different
  frames of the stream).
* ``space``: spatial parallelism — the output canvas is split into
  horizontal row *bands*, one per device, with halo rows *recomputed* on
  both neighbors instead of exchanged (remap is a pure per-pixel gather,
  so recompute is cheaper than a round-trip).  For wide multiband
  blends the halo is kept SMALL by a two-level decomposition: fine
  pyramid levels 0..L-1 run band-locally under a ``5 * 2^L`` halo, and
  the coarse levels L..B run redundantly on the global canvas from an
  all-gathered level-L Gaussian (a few hundred KB per 4K frame — the
  only image bytes that ever cross devices); a single-level ``5 * 2^B``
  halo would make the recomputed band several times the band itself.
  Remaining cross-device traffic: the level-L gather plus a psum of the
  tiny exposure-gain sums.

The per-shard compute path is the SAME one the single-device ``Mapper``
runs: per-input packed remap gathers (``ops/remap.py``; per-shard plans
are built over each band's window maps and stacked on a leading S axis),
banded-matmul blend pyramids, working-grid exposure gains on the
identical global subsample grid, overlay paste, and packed YUV420P
output per band.

Inputs are replicated across 'space' (every device gathers from the full
camera frames); the per-shard gather tables, blend weights and masks are
*sharded constants* carried on the leading S axis.
"""

import math
from dataclasses import dataclass, field
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from scipy.ndimage import distance_transform_edt

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
from ..ops.pyramid import down_matrix, pyr_down_mm, pyr_up_mm, up_matrix
from ..ops.remap import (
    pack_planes,
    remap_apply_packed,
    remap_plan,
    stack_remap_plans,
)
from ..ops.resize import resize_bilinear
from ..stitch.blenders import WEIGHT_EPS, gather_dtype, np_pyr_down
from ..stitch.gain import ALPHA, BETA
from ..stitch.gain_blocks import (
    assemble_and_solve_lattice,
    build_blocks_gain_plan,
)
from ..stitch.mapper import DEFAULT_BLEND_DTYPE, WORKING_MEGAPIX
from ..template.compiler import MapperTemplate
from ..utils.pytree import register_plan

__all__ = ["ShardedMapper", "ShardedPlan", "make_mesh"]


def make_mesh(n_data: int, n_space: int, devices=None):
    devices = devices if devices is not None else jax.devices()
    assert n_data * n_space <= len(devices)
    dev = np.array(devices[: n_data * n_space]).reshape(n_data, n_space)
    return Mesh(dev, axis_names=("data", "space"))


@dataclass
class ShardedPlan:
    # static geometry
    num_inputs: int
    num_overlays: int
    S: int
    bh: int  # band height (canvas rows per shard)
    halo: int
    ext: int  # bh + 2*halo
    Hp: int  # padded canvas height (S * bh)
    Wp: int  # padded canvas width
    canvas_size: tuple  # true (W, H)
    blend_kind: str
    num_bands: int
    stride: int  # working-grid stride (gains), divides bh
    N: tuple  # gain pair counts, nested tuple
    pairs: tuple
    compute_dtype: str = "float32"  # multiband pyramid precision
    pipeline: str = "rgb"  # "rgb" | "yuv420"
    num_bands_uv: int = 0
    frame_format: str = "yuv420p"  # "yuv420p" | "nv12" (in AND out)
    # output resize (mapper.cpp:285-311 out_size semantics): Y resizes
    # at full res, chroma at half res, each band emitting its own
    # output-row slice from its extended (halo-covered) rows
    out_size: tuple = None  # (ow, oh); == canvas_size when unscaled
    obh: int = 0  # output band rows (== bh when unscaled)
    oW: int = 0  # output band width (== Wp when unscaled)
    # per-input aligned band ROIs (VERDICT r2 item 2): work is ROI-sized,
    # not band-sized.  x extent is shard-independent (bands split rows);
    # the y window has a homogenized height and a per-shard offset.
    ralign: int = 1  # ROI alignment: lcm(2^B, stride, chroma needs)
    ghalo: int = 0  # halo // stride (gain-grid rows of halo)
    rois: tuple = ()  # per input (ix0, iw, hmax) — canvas-x, window h
    # per input: band-row offset when identical on every shard (the
    # common case: side cameras, or S == 1 — placement is a STATIC
    # slice), else None and the offset rides in the roi_oy leaf
    roi_oy_static: tuple = ()
    # sharded constants, leading axis S
    roi_oy: object = None  # [S, ncam+nov] i32 per-shard band-row offsets
    # per input: RemapPlan over its band window with [S, ...] leaves
    remaps: tuple = ()
    remaps_uv: tuple = ()  # half-res chroma plans (yuv420 pipeline)
    # per-shard output-resize row tables (band-local gather indices) and
    # replicated column tables; None when out_size == canvas_size
    resize_v: object = None  # dict(y0, y1: [S, obh] i32; fy: [S, obh] f32)
    resize_h: object = None  # dict(x0, x1: [ow] i32; fx: [ow] f32)
    resize_v_uv: object = None
    resize_h_uv: object = None
    gain_blocks: object = None  # replicated BlocksGainPlan ("blocks")
    # two-level multiband decomposition (communication-avoiding halos):
    # levels < split_level run band-locally with a 5*2^L halo; levels
    # >= split_level run on the GLOBAL canvas from an all-gathered
    # level-L Gaussian (tiny), so the halo no longer scales with 2^B.
    # split_level == -1 (or == num_bands) keeps the single-level path.
    split_level: int = -1
    split_level_uv: int = -1
    # [coarse level][input] -> [Hp>>l, iw_i>>l] replicated
    wp_coarse: Optional[List] = None
    inv_bw_coarse: Optional[List] = None  # per level: [Hp>>l, Wp>>l]
    wp_coarse_uv: Optional[List] = None
    inv_bw_coarse_uv: Optional[List] = None
    # per-shard extended-band row gather into the global level-L acc
    # (reflect-101 about the union box, precomputed)
    coarse_row_idx: object = None  # [S, ext>>L] i32
    coarse_row_idx_uv: object = None
    # union-box clamps (multiband only, set only when the camera union
    # does NOT cover the whole canvas): zero the blended band outside
    # the union so reflect-extended constants never leak into rows the
    # single chip leaves black
    union_row_mask: object = None  # [S, ext] f32
    union_row_mask_uv: object = None  # [S, ext/2] f32
    union_col_mask: object = None  # [Wp] f32
    union_col_mask_uv: object = None  # [Wp/2] f32
    feather_w: object = None  # list per input: [S, hmax_i, iw_i] f32
    feather_w_uv: object = None  # list per input: [S, hmax_i/2, iw_i/2]
    # nested lists: [level][input] -> [S, hmax_i>>l, iw_i>>l]
    weight_pyrs: Optional[List] = None
    inv_band_weights: Optional[List] = None  # per level: [S, ext>>l, Wp>>l]
    weight_pyrs_uv: Optional[List] = None
    inv_band_weights_uv: Optional[List] = None
    gm_i: object = None  # [S, P, gh, gw] f32 pair masks (image i side)
    gm_j: object = None  # [S, P, gh, gw] f32
    overlay_masks: object = None  # [S, nov, bh, Wp] f32 (interior rows)
    overlay_masks_uv: object = None  # [S, nov, bh/2, Wp/2] f32
    # replicated constants
    vignette: object = None  # [ncam+nov, Hf, Wf] f32 (ones if unused)
    vignette_half: object = None  # [ncam+nov, Hf/2, Wf/2] f32
    gain_b: object = None  # [ncam] f32
    gain_A_static: object = None  # [ncam, ncam] f32
    chroma_up: object = None  # [Wf/2, Wf] f32 chroma upsample matrix
    chroma_down: object = None  # [Wp, Wp/2] f32 chroma subsample matrix
    pool_cols_roi: object = None  # dict {iw: [iw, iw/stride]} pool matrix
    pool_cols_roi_uv: object = None  # dict {iw/2: [iw/2, iw/stride]}
    down_mats: dict = field(default_factory=dict)  # {n: [n/2, n]}
    up_mats: dict = field(default_factory=dict)  # {n: [2n, n]}


register_plan(
    ShardedPlan,
    children=(
        "roi_oy",
        "remaps",
        "remaps_uv",
        "resize_v",
        "resize_h",
        "resize_v_uv",
        "resize_h_uv",
        "gain_blocks",
        "wp_coarse",
        "inv_bw_coarse",
        "wp_coarse_uv",
        "inv_bw_coarse_uv",
        "coarse_row_idx",
        "coarse_row_idx_uv",
        "union_row_mask",
        "union_row_mask_uv",
        "union_col_mask",
        "union_col_mask_uv",
        "feather_w",
        "feather_w_uv",
        "weight_pyrs",
        "inv_band_weights",
        "weight_pyrs_uv",
        "inv_band_weights_uv",
        "gm_i",
        "gm_j",
        "overlay_masks",
        "overlay_masks_uv",
        "vignette",
        "vignette_half",
        "gain_b",
        "gain_A_static",
        "chroma_up",
        "chroma_down",
        "pool_cols_roi",
        "pool_cols_roi_uv",
        "down_mats",
        "up_mats",
    ),
    static=(
        "num_inputs",
        "num_overlays",
        "S",
        "bh",
        "halo",
        "ext",
        "Hp",
        "Wp",
        "canvas_size",
        "blend_kind",
        "num_bands",
        "stride",
        "N",
        "pairs",
        "compute_dtype",
        "pipeline",
        "num_bands_uv",
        "frame_format",
        "out_size",
        "obh",
        "oW",
        "split_level",
        "split_level_uv",
        "ralign",
        "ghalo",
        "rois",
        "roi_oy_static",
    ),
)

# leaves with the leading S axis (sharded over 'space'); the rest are
# replicated
_SPACE_FIELDS = (
    "roi_oy",
    "remaps",
    "remaps_uv",
    "resize_v",
    "resize_v_uv",
    "coarse_row_idx",
    "coarse_row_idx_uv",
    "union_row_mask",
    "union_row_mask_uv",
    "feather_w",
    "feather_w_uv",
    "weight_pyrs",
    "inv_band_weights",
    "weight_pyrs_uv",
    "inv_band_weights_uv",
    "gm_i",
    "gm_j",
    "overlay_masks",
    "overlay_masks_uv",
)


def _round_up(v, m):
    return (v + m - 1) // m * m


def _round_down(v, m):
    return v // m * m


def _coarse_row_map(n, lo, hi, start, nrows):
    """Extended-band row gather into the global level-L reconstruction.

    Top overshoot uses reflect-101 about the union top (an even anchor
    at every level, so 101 survives downsampling).  Bottom overshoot
    uses SYMMETRIC reflection about hi-0.5: the union bottom anchor
    (hi-1) is odd in general, and reflect-101 level-0 data downsamples
    to the symmetric extension at coarser levels — this matches what
    the single-level band pyramids (and therefore the single-chip
    blend) effectively compute beyond the canvas bottom."""
    idx = np.arange(start, start + n)
    r = np.where(idx < lo, 2 * lo - idx, idx)
    r = np.where(r > hi - 1, 2 * hi - 1 - r, r)
    return np.clip(r, 0, nrows - 1).astype(np.int32)


def _full_canvas_maps(mt: MapperTemplate, Hp, Wp):
    """Paste each input's ROI maps into padded full-canvas maps (-1 =
    invalid).  Includes overlay inputs after the blend inputs."""
    maps = []
    for inp in mt.inputs + mt.overlay_inputs:
        m1 = np.full((Hp, Wp), -1.0, dtype=np.float32)
        m2 = np.full((Hp, Wp), -1.0, dtype=np.float32)
        x, y, w, h = inp.roi
        m1[y : y + h, x : x + w] = inp.map1
        m2[y : y + h, x : x + w] = inp.map2
        maps.append((m1, m2))
    return maps


def build_sharded_plan(
    mt: MapperTemplate,
    in_sizes,
    n_space: int,
    blend: int = 128,
    enable_gain: bool = True,
    blend_dtype: str = "float32",
    pipeline: str = "rgb",
    scale_output=None,
    frame_format: str = "yuv420p",
    coarse_split=None,
) -> ShardedPlan:
    """Per-input aligned band ROIs (the reference's per-region
    ROI-cropped Mapper work, async.cpp:247-259 + the aligned-ROI
    GPUStaticBlender geometry, blenders.cpp:594-640): every per-frame
    stage — remap gather, gain pooling, blend pyramids — runs at window
    size [hmax_i, iw_i], not band size [ext, Wp].  The x window is
    shard-independent (bands split rows); the y window is homogenized to
    one height per input across shards, with the per-shard row offset a
    static slice when it coincides on every shard (always at S=1) and a
    tiny ``roi_oy`` plan leaf otherwise."""
    if blend_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"blend dtype must be 'float32' or 'bfloat16', got {blend_dtype!r}"
        )
    assert pipeline in ("rgb", "yuv420")
    assert frame_format in ("yuv420p", "nv12")
    W, H = mt.out_size
    ncam = len(mt.inputs)
    nov = len(mt.overlay_inputs)
    ntotal = ncam + nov
    # in_sizes may cover cameras only; overlays default to the first size
    in_sizes = [tuple(s) for s in in_sizes]
    if len(in_sizes) == ncam and nov:
        in_sizes = in_sizes + [in_sizes[0]] * nov
    assert len(in_sizes) == ntotal
    if pipeline == "yuv420":
        assert all(
            h % 2 == 0 and w % 2 == 0 for h, w in in_sizes
        ), "yuv420 pipeline needs even camera sizes"
    out_size = tuple(scale_output) if scale_output else (W, H)
    if pipeline == "yuv420" or frame_format == "nv12":
        assert out_size[0] % 2 == 0 and out_size[1] % 2 == 0

    if blend > 0:
        B = int(math.ceil(math.log(blend) / math.log(2.0)) - 1.0)
        kind = "multiband"
    elif blend < 0:
        B = 0
        kind = "feather"
    else:
        B = 0
        kind = "none"

    # working-grid stride (same pow2 selection as Mapper, mapper.py);
    # band heights are padded so stride | bh and every shard sees the
    # same static subsample offsets
    working_scale = min(1.0, math.sqrt(WORKING_MEGAPIX * 1e6 / (W * H)))
    stride = max(1, int(round(1.0 / working_scale)))
    stride = 1 << max(0, int(round(math.log2(stride))))

    step = 1 << B
    # two-level split decision (communication-avoiding halos): band-
    # local fine levels 0..L-1 need only a 5*2^L halo; levels L..B run
    # on the global canvas from an all-gathered level-L Gaussian, so
    # the halo recompute stops scaling with the blend width (halo 320
    # at blend=128 single-level, against 5*2^L = 20 rows split).
    if coarse_split is None:
        L = 2 if (kind == "multiband" and n_space > 1 and B > 2) else B
    else:
        L = max(1, min(int(coarse_split), B))
    split = kind == "multiband" and L < B
    fine_step = (1 << L) if split else step
    # x alignment supports STATIC offsets at every level up to B; the
    # y (band) alignment only the band-local fine levels, plus the gain
    # working grid (stride) and the YUV420 2x2 grid
    ralign = max(step, stride, 4)
    ralign_y = max(fine_step, stride, 4) if split else ralign
    # Hp: divisible by n_space*ralign_y (band slicing) AND step (global
    # coarse grids)
    _m = n_space * ralign_y
    Hp = _round_up(H, _m * step // math.gcd(_m, step))
    Wp = _round_up(W, ralign)
    bh = Hp // n_space
    halo = 5 * fine_step if kind == "multiband" else 8
    halo = _round_up(halo, ralign_y)
    ow, oh = out_size
    obh = bh
    if out_size != (W, H):
        # each shard emits its own output-row slice; its vertical taps
        # (INTER_LINEAR: ys = (yo+0.5)*H/oh - 0.5, clamped) must stay
        # inside the extended band, so grow the halo to cover the
        # worst-case overshoot past the band interior
        obh = _round_up(oh, n_space * 2) // n_space
        need = 0
        for s in range(n_space):
            for src_h, dst_h, b_l in (
                (H, oh, bh),
                (H // 2, oh // 2, bh // 2),
            ):
                nrows = obh if src_h == H else obh // 2
                yo = s * nrows + np.arange(nrows)
                ys = (yo + 0.5) * (src_h / dst_h) - 0.5
                y0 = np.clip(np.floor(ys), 0, src_h - 1).astype(np.int64)
                y1 = np.minimum(y0 + 1, src_h - 1)
                top = s * b_l
                scale_up = 1 if src_h == H else 2
                need = max(
                    need,
                    (top - int(y0.min())) * scale_up,
                    (int(y1.max()) - (top + b_l - 1)) * scale_up,
                )
        if n_space > 1 and need > 0:
            halo = max(halo, _round_up(need, ralign_y))
    if n_space == 1:
        halo = 0  # no neighbor bands: halo rows would be pure padding
        split = False
        L = B
        fine_step = step
    ext = bh + 2 * halo
    S = n_space
    assert ext % ralign_y == 0 and halo % max(stride, 1) == 0
    ghalo = halo // stride

    maps = _full_canvas_maps(mt, Hp, Wp)
    all_inputs = mt.inputs + mt.overlay_inputs

    # ---- per-input aligned windows: static x extent, homogenized y
    # height, per-shard y offset.  gap = 5*2^B is the pyramid support of
    # the blend weights (blenders.cpp:625-640); feather weights live
    # strictly inside the mask, overlays are plain pastes -> no gap.
    gap = 5 * step if kind == "multiband" else 0  # x expansion
    gap_y = 5 * fine_step if kind == "multiband" else 0
    # canvas-union aligned bounds: the single-chip blend clips every
    # per-input aligned ROI to this box (blenders.py
    # build_multiband_plan; blenders.cpp:594-640), so its reflect-101
    # pyramid boundary sits at the union edge — equivalently, the
    # single-chip blend equals blending on the INFINITE reflect-101
    # extension about these edges (the dyadic pyramid commutes with
    # reflect-101 at step-aligned anchors).  The sharded constants
    # (maps, seam pyramids, normalizers) are reflect-extended about the
    # same edges below, so edge-band halos see the same extension
    # instead of zeros.
    if kind == "multiband" and ncam:
        arx = _round_down(min(i.roi[0] for i in mt.inputs), step)
        ary = _round_down(min(i.roi[1] for i in mt.inputs), step)
        arx1 = _round_up(
            max(i.roi[0] + i.roi[2] for i in mt.inputs), step
        )
        ary1 = _round_up(
            max(i.roi[1] + i.roi[3] for i in mt.inputs), step
        )
    else:
        arx, ary, arx1, ary1 = 0, 0, Wp, Hp

    def _refl_idx(n, lo, hi, start=0):
        """Gather indices [start, start+n) reflect-101-mapped into
        [lo, hi) (single bounce; clipped for degenerate spans)."""
        idx = np.arange(start, start + n)
        r = np.where(idx < lo, 2 * lo - idx, idx)
        r = np.where(r > hi - 1, 2 * (hi - 1) - r, r)
        return np.clip(r, lo, hi - 1)

    def _refl_fill(a, lo_y, hi_y, lo_x, hi_x):
        """In-array reflect-101 fill of rows/cols outside the union box
        (values there equal the infinite extension's)."""
        a = a[np.clip(_refl_idx(a.shape[0], lo_y, hi_y), 0, a.shape[0] - 1)]
        return a[
            :, np.clip(_refl_idx(a.shape[1], lo_x, hi_x), 0, a.shape[1] - 1)
        ]

    rois = []
    oy_table = np.zeros((S, ntotal), dtype=np.int32)
    oy_static = []
    for idx, inp in enumerate(all_inputs):
        x, y, w_, h_ = inp.roi
        g = gap if idx < ncam else 0
        gy = gap_y if idx < ncam else 0
        x0 = max(0, _round_down(x - g, ralign))
        x1 = min(Wp, _round_up(x + w_ + g, ralign))
        iw = x1 - x0
        wins = []
        for s in range(S):
            top = s * bh - halo
            ly0 = max(0, _round_down(y - gy - top, ralign_y))
            ly1 = min(ext, _round_up(y + h_ + gy - top, ralign_y))
            wins.append((ly0, ly1) if ly1 > ly0 else None)
        hmax = max((w1 - w0 for w in wins if w for (w0, w1) in [w]), default=0)
        hmax = min(ext, max(hmax, ralign_y))
        oys = []
        for s, wnd in enumerate(wins):
            o = 0 if wnd is None else min(wnd[0], ext - hmax)
            oys.append(o)
            oy_table[s, idx] = o
        rois.append((x0, iw, hmax))
        oy_static.append(
            oys[0] if all(o == oys[0] for o in oys) else None
        )

    def band_slice(arr, s, level=0, pad_value=0.0, reflect=False):
        """Rows of the extended band s from a full padded array at pyramid
        level ``level``.  ``reflect=True``: rows outside the union box
        come from its reflect-101 extension (multiband constants);
        otherwise ``pad_value``-padded outside the canvas."""
        h_l = halo >> level
        bh_l = bh >> level
        top = s * bh_l - h_l
        n = bh_l + 2 * h_l
        if reflect:
            r = _refl_idx(n, ary >> level, ary1 >> level, start=top)
            return arr[np.clip(r, 0, arr.shape[0] - 1)]
        pad = np.full((h_l,) + arr.shape[1:], pad_value, dtype=arr.dtype)
        big = np.concatenate([pad, arr, pad], axis=0)
        return big[top + h_l : top + h_l + bh_l + 2 * h_l]

    def wslice(arr, s, idx, level=0, pad_value=0.0, reflect=False):
        """Input ``idx``'s window of band ``s`` at pyramid ``level``."""
        x0, iw, hmax = rois[idx]
        b = band_slice(
            arr, s, level=level, pad_value=pad_value, reflect=reflect
        )
        o = int(oy_table[s, idx]) >> level
        return b[
            o : o + (hmax >> level), (x0 >> level) : ((x0 + iw) >> level)
        ]

    # ---- remap plans over window map slices: one per input and shard,
    # stacked on S (every shard's window of an input has the same
    # [hmax_i, iw_i] shape; pixels outside the maps have weight 0).
    # Multiband camera maps are reflect-extended about the union box:
    # reflecting MAP values reproduces the warped-image reflection the
    # single-chip pyramid applies at its aligned-ROI boundary exactly
    # (warped[r] = f(map[r]) pointwise).  Overlays are pastes — no
    # reflection.
    if kind == "multiband":
        maps = [
            (
                (
                    _refl_fill(m1, ary, ary1, arx, arx1),
                    _refl_fill(m2, ary, ary1, arx, arx1),
                )
                if i < ncam
                else (m1, m2)
            )
            for i, (m1, m2) in enumerate(maps)
        ]

    def _cam_refl(i):
        return kind == "multiband" and i < ncam

    remaps = tuple(
        stack_remap_plans(
            [
                remap_plan(
                    wslice(m1, s, i, pad_value=-1.0, reflect=_cam_refl(i)),
                    wslice(m2, s, i, pad_value=-1.0, reflect=_cam_refl(i)),
                    *in_sizes[i],
                )
                for s in range(S)
            ]
        )
        for i, (m1, m2) in enumerate(maps)
    )

    B_uv = max(1, B - 1) if kind == "multiband" else 0
    plan = ShardedPlan(
        num_inputs=ncam,
        num_overlays=nov,
        S=S,
        bh=bh,
        halo=halo,
        ext=ext,
        Hp=Hp,
        Wp=Wp,
        canvas_size=(W, H),
        blend_kind=kind,
        num_bands=B,
        num_bands_uv=B_uv,
        stride=stride,
        N=(),
        pairs=(),
        remaps=remaps,
        pipeline=pipeline,
        frame_format=frame_format,
        out_size=out_size,
        obh=obh,
        oW=(ow if out_size != (W, H) else Wp),
        ralign=ralign_y,
        ghalo=ghalo,
        rois=tuple(rois),
        roi_oy_static=tuple(oy_static),
        roi_oy=oy_table,
    )

    bh2, halo2 = bh // 2, halo // 2
    ext2 = ext // 2

    def bs_uv(arr, s, level=0, pad_value=0.0, reflect=False):
        h_l = halo2 >> level
        bh_l = bh2 >> level
        top = s * bh_l - h_l
        n = bh_l + 2 * h_l
        if reflect:
            r = _refl_idx(
                n, (ary // 2) >> level, (ary1 // 2) >> level, start=top
            )
            return arr[np.clip(r, 0, arr.shape[0] - 1)]
        pad = np.full((h_l,) + arr.shape[1:], pad_value, dtype=arr.dtype)
        big = np.concatenate([pad, arr, pad], axis=0)
        return big[top + h_l : top + h_l + bh_l + 2 * h_l]

    def wslice_uv(arr, s, idx, level=0, pad_value=0.0, reflect=False):
        x0, iw, hmax = rois[idx]
        b = bs_uv(
            arr, s, level=level, pad_value=pad_value, reflect=reflect
        )
        o = (int(oy_table[s, idx]) // 2) >> level
        return b[
            o : o + ((hmax // 2) >> level),
            ((x0 // 2) >> level) : (((x0 + iw) // 2) >> level),
        ]

    # ---- yuv420: half-resolution chroma geometry (windows at /2 with
    # halo/2; B_uv = B-1 keeps the same spatial blur extent and halo
    # alignment since ralign >= 4)
    if pipeline == "yuv420":
        from ..stitch.yuv_mode import half_maps as _half_maps

        assert bh % 2 == 0 and halo % 2 == 0 and Wp % 2 == 0
        full_roi = (0, 0, Wp, Hp)
        maps_uv = [_half_maps(m1, m2, full_roi)[:2] for (m1, m2) in maps]
        if kind == "multiband":
            maps_uv = [
                (
                    (
                        _refl_fill(
                            m1, ary // 2, ary1 // 2, arx // 2, arx1 // 2
                        ),
                        _refl_fill(
                            m2, ary // 2, ary1 // 2, arx // 2, arx1 // 2
                        ),
                    )
                    if i < ncam
                    else (m1, m2)
                )
                for i, (m1, m2) in enumerate(maps_uv)
            ]
        plan.remaps_uv = tuple(
            stack_remap_plans(
                [
                    remap_plan(
                        wslice_uv(m1, s, i, pad_value=-1.0, reflect=_cam_refl(i)),
                        wslice_uv(m2, s, i, pad_value=-1.0, reflect=_cam_refl(i)),
                        in_sizes[i][0] // 2,
                        in_sizes[i][1] // 2,
                    )
                    for s in range(S)
                ]
            )
            for i, (m1, m2) in enumerate(maps_uv)
        )

    # ---- full-canvas masks (u8) per input
    full_masks = []
    for inp in mt.inputs:
        fm = np.zeros((Hp, Wp), dtype=np.uint8)
        x, y, w_, h_ = inp.roi
        fm[y : y + h_, x : x + w_] = inp.mask
        full_masks.append(fm)

    def h2(a):
        return (
            a.reshape(Hp // 2, 2, Wp // 2, 2).mean(axis=(1, 3))
        ).astype(np.float32)

    # ---- blend constants (window-sized per input; band-sized
    # normalizers)
    if kind == "feather":
        border = -blend
        dst = np.full((Hp, Wp), WEIGHT_EPS, dtype=np.float32)
        raw = []
        for fm in full_masks:
            wmap = distance_transform_edt(fm > 0).astype(np.float32) - border
            np.maximum(wmap, 0.0, out=wmap)
            raw.append(wmap)
            dst += wmap
        norm = [wm / dst for wm in raw]
        plan.feather_w = [
            np.stack([wslice(wm, s, i) for s in range(S)])
            for i, wm in enumerate(norm)
        ]
        if pipeline == "yuv420":
            norm_uv = [h2(wm) for wm in norm]
            plan.feather_w_uv = [
                np.stack([wslice_uv(wm, s, i) for s in range(S)])
                for i, wm in enumerate(norm_uv)
            ]
    elif kind == "multiband":
        full_seams = []
        for inp, sm in zip(mt.inputs, mt.seam_masks):
            fs = np.zeros((Hp, Wp), dtype=np.float32)
            x, y, w_, h_ = inp.roi
            fs[y : y + h_, x : x + w_] = sm.astype(np.float32) / 255.0
            full_seams.append(fs)

        # full-canvas weight pyramids, reflect-filled about the union
        # box at EVERY level before the next downsample — each stored
        # level then equals the infinite reflect-101 extension's values
        # (what the single-chip per-input pyramid computes at its
        # aligned-ROI boundary)
        pyrs = []  # [ncam][level]
        for fs in full_seams:
            pyr = [_refl_fill(fs, ary, ary1, arx, arx1)]
            for l in range(B):
                nxt = np_pyr_down(pyr[-1])
                nxt = _refl_fill(
                    nxt,
                    ary >> (l + 1),
                    ary1 >> (l + 1),
                    arx >> (l + 1),
                    arx1 >> (l + 1),
                )
                pyr.append(nxt)
            pyrs.append(pyr)
        bw = [
            np.sum([p[l] for p in pyrs], axis=0) + WEIGHT_EPS
            for l in range(B + 1)
        ]
        # band-local levels: all B+1 on the single-level path; only the
        # fine levels 0..L-1 when the two-level split is active (the
        # coarse levels then come from the all-gathered global path)
        n_fine = L if split else B + 1
        # nested [level][input] -> [S, hmax_i>>l, iw_i>>l]
        plan.weight_pyrs = [
            [
                np.stack(
                    [
                        wslice(p[l], s, i, level=l, reflect=True)
                        for s in range(S)
                    ]
                )
                for i, p in enumerate(pyrs)
            ]
            for l in range(n_fine)
        ]
        plan.inv_band_weights = [
            np.stack(
                [
                    band_slice(bw[l], s, level=l, reflect=True)
                    for s in range(S)
                ]
            )
            for l in range(n_fine)
        ]
        for l in range(n_fine):
            plan.inv_band_weights[l] = (
                1.0 / np.maximum(plan.inv_band_weights[l], WEIGHT_EPS)
            ).astype(np.float32)
        if split:
            plan.split_level = L
            # global coarse constants (tiny): per-input weight pyramids
            # at the input's x window, global rows; global inverse band
            # weights; per-shard extended-band row gather into the
            # global level-L reconstruction (reflect about the union)
            plan.wp_coarse = [
                [
                    pyrs[i][l][:, (x0 >> l) : ((x0 + iw) >> l)]
                    for i, (x0, iw, hmax) in enumerate(rois[:ncam])
                ]
                for l in range(L, B + 1)
            ]
            plan.inv_bw_coarse = [
                (1.0 / np.maximum(bw[l], WEIGHT_EPS)).astype(np.float32)
                for l in range(L, B + 1)
            ]
            ridx = np.zeros((S, ext >> L), np.int32)
            for s in range(S):
                top = (s * bh - halo) >> L
                r = _coarse_row_map(
                    ext >> L, ary >> L, ary1 >> L, top, Hp >> L
                )
                ridx[s] = r
            plan.coarse_row_idx = ridx
        # banded pyramid matrices for every axis length the blend touches
        down_mats, up_mats = {}, {}
        lengths = set()
        for l in range(B + 1):
            lengths.add(ext >> l)
            lengths.add(Wp >> l)
            lengths.add(Hp >> l)
            for (x0, iw, hmax) in rois[:ncam]:
                lengths.add(hmax >> l)
                lengths.add(iw >> l)
        for nl in lengths:
            if nl >= 2:
                down_mats[nl] = down_matrix(nl)
                up_mats[nl >> 1] = up_matrix(nl >> 1)
        plan.down_mats = down_mats
        plan.up_mats = up_mats
        if blend_dtype == "bfloat16":
            # bf16 pyramid constants (same 16-bit role as the
            # reference's CV_16S GPU pyramids); accumulation stays f32
            # in the matmuls
            bd = np.dtype(jnp.bfloat16)
            plan.weight_pyrs = [
                [p.astype(bd) for p in lvl] for lvl in plan.weight_pyrs
            ]
            plan.inv_band_weights = [
                b.astype(bd) for b in plan.inv_band_weights
            ]
            if split:
                plan.wp_coarse = [
                    [p.astype(bd) for p in lvl] for lvl in plan.wp_coarse
                ]
                plan.inv_bw_coarse = [
                    b.astype(bd) for b in plan.inv_bw_coarse
                ]
            plan.down_mats = {k: v.astype(bd) for k, v in down_mats.items()}
            plan.up_mats = {k: v.astype(bd) for k, v in up_mats.items()}
            plan.compute_dtype = "bfloat16"

        if pipeline == "yuv420":
            # chroma blend at half resolution with B_uv = B-1 bands
            # (same spatial blur extent; halo/2 keeps level alignment)
            pyrs_uv = []
            for fs in full_seams:
                pyr = [
                    _refl_fill(
                        h2(fs), ary // 2, ary1 // 2, arx // 2, arx1 // 2
                    )
                ]
                for l in range(B_uv):
                    nxt = np_pyr_down(pyr[-1])
                    nxt = _refl_fill(
                        nxt,
                        (ary // 2) >> (l + 1),
                        (ary1 // 2) >> (l + 1),
                        (arx // 2) >> (l + 1),
                        (arx1 // 2) >> (l + 1),
                    )
                    pyr.append(nxt)
                pyrs_uv.append(pyr)
            bw_uv = [
                np.sum([p[l] for p in pyrs_uv], axis=0) + WEIGHT_EPS
                for l in range(B_uv + 1)
            ]
            L_uv = max(1, L - 1) if split else B_uv
            split_uv = split and L_uv < B_uv and halo2 >= 5 * (1 << L_uv)
            if not split_uv:
                L_uv = B_uv
            n_fine_uv = L_uv if split_uv else B_uv + 1
            plan.weight_pyrs_uv = [
                [
                    np.stack(
                        [
                            wslice_uv(p[l], s, i, level=l, reflect=True)
                            for s in range(S)
                        ]
                    )
                    for i, p in enumerate(pyrs_uv)
                ]
                for l in range(n_fine_uv)
            ]
            plan.inv_band_weights_uv = [
                np.stack(
                    [
                        bs_uv(bw_uv[l], s, level=l, reflect=True)
                        for s in range(S)
                    ]
                )
                for l in range(n_fine_uv)
            ]
            for l in range(n_fine_uv):
                plan.inv_band_weights_uv[l] = (
                    1.0
                    / np.maximum(plan.inv_band_weights_uv[l], WEIGHT_EPS)
                ).astype(np.float32)
            if split_uv:
                plan.split_level_uv = L_uv
                plan.wp_coarse_uv = [
                    [
                        pyrs_uv[i][l][
                            :, ((x0 // 2) >> l) : (((x0 + iw) // 2) >> l)
                        ]
                        for i, (x0, iw, hmax) in enumerate(rois[:ncam])
                    ]
                    for l in range(L_uv, B_uv + 1)
                ]
                plan.inv_bw_coarse_uv = [
                    (1.0 / np.maximum(bw_uv[l], WEIGHT_EPS)).astype(
                        np.float32
                    )
                    for l in range(L_uv, B_uv + 1)
                ]
                ridx = np.zeros((S, ext2 >> L_uv), np.int32)
                for s in range(S):
                    top = (s * bh2 - halo2) >> L_uv
                    r = _coarse_row_map(
                        ext2 >> L_uv,
                        (ary // 2) >> L_uv,
                        (ary1 // 2) >> L_uv,
                        top,
                        (Hp // 2) >> L_uv,
                    )
                    ridx[s] = r
                plan.coarse_row_idx_uv = ridx
            lengths = set()
            for l in range(B_uv + 1):
                lengths.add(ext2 >> l)
                lengths.add((Wp // 2) >> l)
                lengths.add((Hp // 2) >> l)
                for (x0, iw, hmax) in rois[:ncam]:
                    lengths.add((hmax // 2) >> l)
                    lengths.add((iw // 2) >> l)
            for nl in lengths:
                if nl >= 2 and nl not in plan.down_mats:
                    plan.down_mats[nl] = down_matrix(nl)
                    plan.up_mats[nl >> 1] = up_matrix(nl >> 1)
            if blend_dtype == "bfloat16":
                bd = np.dtype(jnp.bfloat16)
                plan.weight_pyrs_uv = [
                    [p.astype(bd) for p in lvl]
                    for lvl in plan.weight_pyrs_uv
                ]
                plan.inv_band_weights_uv = [
                    b.astype(bd) for b in plan.inv_band_weights_uv
                ]
                if split_uv:
                    plan.wp_coarse_uv = [
                        [p.astype(bd) for p in lvl]
                        for lvl in plan.wp_coarse_uv
                    ]
                    plan.inv_bw_coarse_uv = [
                        b.astype(bd) for b in plan.inv_bw_coarse_uv
                    ]
                plan.down_mats = {
                    k: (v.astype(bd) if v.dtype != bd else v)
                    for k, v in plan.down_mats.items()
                }
                plan.up_mats = {
                    k: (v.astype(bd) if v.dtype != bd else v)
                    for k, v in plan.up_mats.items()
                }

    # ---- gain constants on the global working grid (exact Mapper
    # parity: same stride, same subsample origin, psum over 'space')
    if enable_gain and ncam > 1:
        assert bh % stride == 0 and Wp % stride == 0
        # block-pooled masks (full coverage only), matching the Mapper's
        # box-mean working grid
        work = []
        for fm in full_masks:
            mb = (fm > 0).astype(np.float32)
            pooled = mb.reshape(
                Hp // stride, stride, Wp // stride, stride
            ).mean(axis=(1, 3))
            work.append(pooled > 0.999)
        gh_total, gw = work[0].shape
        gh = bh // stride  # work rows per shard
        pairs = []
        N = np.zeros((ncam, ncam), dtype=np.int64)
        gm_i, gm_j = [], []
        for i in range(ncam):
            N[i, i] = max(1, int(np.count_nonzero(work[i])))
        for i in range(ncam):
            for j in range(i + 1, ncam):
                inter = work[i] & work[j]
                cnt = int(inter.sum())
                N[i, j] = N[j, i] = max(1, cnt)
                if cnt:
                    pairs.append((i, j))
                    gm_i.append(inter.astype(np.float32))
                    gm_j.append(inter.astype(np.float32))
        plan.N = tuple(tuple(int(v) for v in row) for row in N)
        plan.pairs = tuple(pairs)
        if pairs:
            stack = np.stack(gm_i)  # [P, gh_total, gw]
            plan.gm_i = np.stack(
                [stack[:, s * gh : (s + 1) * gh] for s in range(S)]
            )
            plan.gm_j = plan.gm_i
        plan.gain_b = (BETA * N.sum(axis=1)).astype(np.float32)
        plan.gain_A_static = np.diag(BETA * N.sum(axis=1)).astype(np.float32)

        if enable_gain == "blocks":
            # BlocksGainCompensator lattice (exposure_compensate.cpp:
            # 330-438) on the SAME working grid as the single-chip
            # Mapper: cover/counts replicated, per-shard partial block
            # sums psum'd at solve time (_solve_band_block_lattice)
            ws_w, ws_h = -(-W // stride), -(-H // stride)
            masks_ws = [
                (wk[:ws_h, :ws_w]).astype(np.uint8) * 255 for wk in work
            ]
            plan.gain_blocks = build_blocks_gain_plan(
                masks_ws, [(0, 0, ws_w, ws_h)] * ncam, (ws_w, ws_h)
            )

    # ---- overlay paste masks (extended-band rows: halo rows feed the
    # output resize taps, and interiors are disjoint so the duplicate
    # halo work is consistent across shards)
    if nov:
        oms = []
        for inp in mt.overlay_inputs:
            fm = np.zeros((Hp, Wp), dtype=np.float32)
            x, y, w_, h_ = inp.roi
            fm[y : y + h_, x : x + w_] = (inp.mask > 0).astype(np.float32)
            oms.append(fm)
        plan.overlay_masks = np.stack(
            [
                np.stack([band_slice(om, s) for om in oms])
                for s in range(S)
            ]
        )
        if pipeline == "yuv420":
            oms_uv = [(h2(om) > 0).astype(np.float32) for om in oms]
            plan.overlay_masks_uv = np.stack(
                [
                    np.stack([bs_uv(om, s) for om in oms_uv])
                    for s in range(S)
                ]
            )

    # ---- union-box clamps (only when the camera union leaves canvas
    # rows/cols uncovered — reflect-extended constants must not leak
    # into areas the single chip leaves black)
    if kind == "multiband" and (
        arx > 0 or ary > 0 or arx1 < W or ary1 < H
    ):
        rows = np.zeros((S, ext), dtype=np.float32)
        rows_uv = np.zeros((S, ext2), dtype=np.float32)
        for s in range(S):
            r = s * bh - halo + np.arange(ext)
            rows[s] = ((r >= ary) & (r < ary1)).astype(np.float32)
            r2 = s * bh2 - halo2 + np.arange(ext2)
            rows_uv[s] = (
                (r2 >= ary // 2) & (r2 < ary1 // 2)
            ).astype(np.float32)
        plan.union_row_mask = rows
        plan.union_row_mask_uv = rows_uv
        c = np.arange(Wp)
        plan.union_col_mask = ((c >= arx) & (c < arx1)).astype(np.float32)
        c2 = np.arange(Wp // 2)
        plan.union_col_mask_uv = (
            (c2 >= arx // 2) & (c2 < arx1 // 2)
        ).astype(np.float32)

    # ---- vignette (replicated; ones where unused; per-input sizes)
    vigs = []
    for idx, inp in enumerate(mt.inputs + mt.overlay_inputs):
        Hi, Wi = in_sizes[idx]
        if inp.vignette is not None:
            vigs.append(
                np.asarray(resize_bilinear(inp.vignette, Hi, Wi)).astype(
                    np.float32
                )
            )
        else:
            vigs.append(np.ones((Hi, Wi), dtype=np.float32))
    plan.vignette = vigs
    if pipeline == "yuv420":
        plan.vignette_half = [
            v.reshape(v.shape[0] // 2, 2, v.shape[1] // 2, 2)
            .mean(axis=(1, 3))
            .astype(np.float32)
            for v in vigs
        ]
    plan.chroma_up = {
        Wi: up_cols_matrix(Wi // 2) for (Hi, Wi) in set(in_sizes)
    }
    plan.chroma_down = down_cols_matrix(ow if out_size != (W, H) else Wp)

    # ---- output-resize gather tables (INTER_LINEAR, ops/resize.py
    # semantics); row indices are band-local per shard
    if out_size != (W, H):

        def vtab(src_h, dst_h, nrows, b_l, h_l):
            y0t = np.zeros((S, nrows), np.int32)
            y1t = np.zeros((S, nrows), np.int32)
            fyt = np.zeros((S, nrows), np.float32)
            for s in range(S):
                yo = s * nrows + np.arange(nrows)
                ys = (yo + 0.5) * (src_h / dst_h) - 0.5
                y0 = np.clip(np.floor(ys), 0, src_h - 1).astype(np.int64)
                y1 = np.minimum(y0 + 1, src_h - 1)
                fy = np.clip(ys - y0, 0.0, 1.0)
                top = s * b_l - h_l
                assert (
                    y0.min() - top >= 0 and y1.max() - top < b_l + 2 * h_l
                ), "scale_output vertical taps escape the extended band"
                y0t[s], y1t[s], fyt[s] = y0 - top, y1 - top, fy
            return dict(y0=y0t, y1=y1t, fy=fyt)

        def htab(src_w, dst_w):
            xs = (np.arange(dst_w) + 0.5) * (src_w / dst_w) - 0.5
            x0 = np.clip(np.floor(xs), 0, src_w - 1).astype(np.int64)
            x1 = np.minimum(x0 + 1, src_w - 1)
            fx = np.clip(xs - x0, 0.0, 1.0)
            return dict(
                x0=x0.astype(np.int32),
                x1=x1.astype(np.int32),
                fx=fx.astype(np.float32),
            )

        plan.resize_v = vtab(H, oh, obh, bh, halo)
        plan.resize_h = htab(W, ow)
        if pipeline == "yuv420":
            plan.resize_v_uv = vtab(
                H // 2, oh // 2, obh // 2, bh // 2, halo // 2
            )
            plan.resize_h_uv = htab(W // 2, ow // 2)
    if stride > 1:
        from ..stitch.mapper import _pool_cols_matrix

        plan.pool_cols_roi = {
            iw: _pool_cols_matrix(iw, stride)
            for (x0, iw, hmax) in set(rois[:ncam])
        }
        if pipeline == "yuv420" and stride > 2:
            plan.pool_cols_roi_uv = {
                iw // 2: _pool_cols_matrix(iw // 2, stride // 2)
                for (x0, iw, hmax) in set(rois[:ncam])
            }

    return plan


# ------------------------------------------------------------------ forward


def _win_oy(plan: ShardedPlan, i: int, div: int = 1):
    """Input i's band-row window offset: a python int when the offset
    coincides on every shard (always at S=1), else the tiny per-shard
    ``roi_oy`` leaf (traced)."""
    o = plan.roi_oy_static[i]
    if o is not None:
        return o // div
    return plan.roi_oy[i] // div


def _paste_add(dst, src, oy, ox):
    """dst[..., oy:oy+h, ox:ox+w] += src.  ``ox`` is always static;
    ``oy`` may be a traced per-shard scalar (dynamic_update_slice)."""
    h, w = src.shape[-2], src.shape[-1]
    if isinstance(oy, (int, np.integer)):
        return dst.at[..., oy : oy + h, ox : ox + w].add(
            src.astype(dst.dtype)
        )
    idx = tuple(jnp.int32(0) for _ in range(dst.ndim - 2)) + (
        jnp.asarray(oy, jnp.int32),
        jnp.int32(ox),
    )
    cur = jax.lax.dynamic_slice(dst, idx, src.shape)
    return jax.lax.dynamic_update_slice(
        dst, (cur + src).astype(dst.dtype), idx
    )


def _window_norm_grid(plan: ShardedPlan, wimg, i, reduce_fn):
    """Pooled working-grid norms of input i's window, pasted into the
    band-interior working grid [gh, gw] — identical global blocks (and
    therefore identical gain sums) to the single-chip Mapper."""
    from ..stitch.mapper import _pool_pow2

    x0, iw, hmax = plan.rois[i]
    st = plan.stride
    x = wimg.astype(jnp.float32)
    x = _pool_pow2(
        x, st, col_mat=(plan.pool_cols_roi[iw] if st > 1 else None)
    )
    nrm = reduce_fn(x)  # [hmax/st, iw/st]
    grid = jnp.zeros((plan.ext // st, plan.Wp // st), jnp.float32)
    grid = _paste_add(grid, nrm, _win_oy(plan, i, div=st), x0 // st)
    gh = plan.bh // st
    return grid[plan.ghalo : plan.ghalo + gh]


def _window_norm_grid_yuv(plan: ShardedPlan, wy, wuv, i):
    """Exact elementNorm working grid for the yuv420 band path: pooled
    luma + pooled centered chroma -> RGB L2 norm (yuv_mode.yuv_rgb_norm),
    pasted into the band-interior grid.  Window offsets are ralign>=4
    aligned, so the chroma window (at /2 geometry) pools onto the SAME
    canvas-aligned working grid as the luma window."""
    from ..stitch.mapper import _pool_pow2
    from ..stitch.yuv_mode import yuv_rgb_norm

    x0, iw, hmax = plan.rois[i]
    st = plan.stride
    y = _pool_pow2(
        wy.astype(jnp.float32),
        st,
        col_mat=(plan.pool_cols_roi[iw] if st > 1 else None),
    )
    uvf = wuv.astype(jnp.float32)
    if st >= 2:
        uv = _pool_pow2(
            uvf,
            st // 2,
            col_mat=(
                plan.pool_cols_roi_uv[iw // 2] if st > 2 else None
            ),
        )
    else:  # stride 1: nearest 2x chroma upsample onto the luma grid
        uv = jnp.repeat(jnp.repeat(uvf, 2, axis=1), 2, axis=2)[
            :, :hmax, :iw
        ]
    nrm = yuv_rgb_norm(y[0], uv[0], uv[1])
    grid = jnp.zeros((plan.ext // st, plan.Wp // st), jnp.float32)
    grid = _paste_add(grid, nrm, _win_oy(plan, i, div=st), x0 // st)
    gh = plan.bh // st
    return grid[plan.ghalo : plan.ghalo + gh]


def _solve_band_gains(plan: ShardedPlan, norms):
    """BL07 pairwise gain solve from per-input band-interior norm grids;
    the pair sums are psum'd across 'space' so every shard solves the
    identical global system."""
    sums = []
    for p, (i, j) in enumerate(plan.pairs):
        sums.append(jnp.sum(norms[i] * plan.gm_i[p]))
        sums.append(jnp.sum(norms[j] * plan.gm_j[p]))
    sums = jax.lax.psum(jnp.stack(sums), "space")
    n = plan.num_inputs
    I = jnp.zeros((n, n), dtype=jnp.float32)
    for p, (i, j) in enumerate(plan.pairs):
        cnt = float(plan.N[i][j])
        I = I.at[i, j].set(sums[2 * p] / cnt)
        I = I.at[j, i].set(sums[2 * p + 1] / cnt)
    Nf = jnp.asarray(np.array(plan.N, dtype=np.float32))
    off = 1.0 - jnp.eye(n, dtype=jnp.float32)
    diag_dyn = jnp.sum(2.0 * ALPHA * I * I * Nf * off, axis=1)
    A = (
        plan.gain_A_static
        + jnp.diag(diag_dyn)
        - 2.0 * ALPHA * I * I.T * Nf * off
    )
    return jnp.linalg.solve(A, plan.gain_b)


def _solve_band_block_lattice(plan: ShardedPlan, norms):
    """Blocks-gain lattice from band-sliced working norms: each shard
    pastes its band-interior norm rows into the (tiny, ~0.1 MP) working
    canvas, computes partial per-block pair sums, and a psum over
    'space' makes every shard solve the identical global lattice —
    BlocksGainCompensator semantics (exposure_compensate.cpp:330-438)
    with the only cross-chip traffic one [B, n, n] reduction."""
    gbp = plan.gain_blocks
    n = gbp.num_images
    Hc, Wc = gbp.canvas
    st = plan.stride
    gh = plan.bh // st
    gw = plan.Wp // st
    block, nby, nbx = gbp.block, gbp.nby, gbp.nbx
    Bb = nby * nbx
    Hbuf = max(Hc, plan.S * gh)
    row0 = jax.lax.axis_index("space") * gh

    canvas_norm = jnp.zeros((n, Hbuf, Wc), jnp.float32)
    for i, nm in enumerate(norms):
        nmw = (
            nm[:, :Wc]
            if gw >= Wc
            else jnp.pad(nm, ((0, 0), (0, Wc - gw)))
        )
        canvas_norm = jax.lax.dynamic_update_slice(
            canvas_norm, nmw[None], (i, row0, 0)
        )
    cover = jnp.asarray(gbp.cover)
    canvas_norm = canvas_norm[:, :Hc] * cover

    def block_sum(a):
        return a.reshape(nby, block, nbx, block).sum(axis=(1, 3))

    I = jnp.zeros((Bb, n, n), dtype=jnp.float32)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            s_ = block_sum(canvas_norm[i] * cover[j]).reshape(Bb)
            I = I.at[:, i, j].set(s_)
    I = jax.lax.psum(I, "space") / jnp.asarray(gbp.N)
    return assemble_and_solve_lattice(gbp, I)


def _sample_lattice_window(plan: ShardedPlan, lattice, i, div=1):
    """Bilinear sample of the block gain lattice over input i's window
    (gain_blocks.sample_block_lattice with a traced per-shard row
    offset).  div=1 samples the luma/rgb grid, div=2 the half-res
    chroma grid (chroma px = 2 luma px, so the lattice scale doubles)."""
    gbp = plan.gain_blocks
    x0, iw, hmax = plan.rois[i]
    oy = _win_oy(plan, i, div=div)
    row_top = (
        jax.lax.axis_index("space") * (plan.bh // div)
        - plan.halo // div
        + oy
    )
    block, nby, nbx = gbp.block, gbp.nby, gbp.nbx
    scale = div / plan.stride
    h, w = hmax // div, iw // div
    ys = ((row_top + jnp.arange(h) + 0.5) * scale) / block - 0.5
    xs = ((x0 // div + jnp.arange(w) + 0.5) * scale) / block - 0.5
    y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, nby - 1)
    x0i = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, nbx - 1)
    y1 = jnp.minimum(y0 + 1, nby - 1)
    x1i = jnp.minimum(x0i + 1, nbx - 1)
    fy = jnp.clip(ys - y0, 0.0, 1.0)[:, None]
    fx = jnp.clip(xs - x0i, 0.0, 1.0)[None, :]
    g = lattice[..., i]
    top = g[y0][:, x0i] * (1 - fx) + g[y0][:, x1i] * fx
    bot = g[y1][:, x0i] * (1 - fx) + g[y1][:, x1i] * fx
    return top * (1 - fy) + bot * fy


def _resize_band(band, vt, ht):
    """Per-shard bilinear output resize of one extended band [c, ext_v,
    W_v] -> [c, obh_v, ow_v]: band-local row taps (per-shard tables) +
    replicated column taps; INTER_LINEAR semantics (ops/resize.py,
    mapper.cpp:285-311)."""
    y0, y1, fy = vt["y0"], vt["y1"], vt["fy"]
    x0, x1, fx = ht["x0"], ht["x1"], ht["fx"]
    work = band.astype(jnp.float32)
    fy_ = fy[None, :, None]
    fx_ = fx[None, None, :]
    r0 = work[:, y0][:, :, x0]
    r1 = work[:, y0][:, :, x1]
    r2 = work[:, y1][:, :, x0]
    r3 = work[:, y1][:, :, x1]
    top = r0 * (1 - fx_) + r1 * fx_
    bot = r2 * (1 - fx_) + r3 * fx_
    return top * (1 - fy_) + bot * fy_


def _blend_windows(
    plan, imgs, wins, weight_pyrs, inv_bw, feather_w, B, ext_v, W_v,
    coarse=None,
):
    """Blend per-input window images into one [c, ext_v, W_v] band.

    imgs: per input [c, hmax_i, iw_i]; wins: per input (x0, iw, hmax,
    oy) in this plane's units (oy may be traced).  Per-input pyramids
    run at window size and paste-add into band-level dst pyramids — the
    aligned-ROI GPUStaticBlender geometry (blenders.cpp:594-640) on a
    band.  ``coarse``: the two-level split context (see
    _blend_windows_split) or None for the single-level path."""
    c = imgs[0].shape[0]
    if plan.blend_kind == "feather":
        band = jnp.zeros((c, ext_v, W_v), dtype=imgs[0].dtype)
        for i, im in enumerate(imgs):
            x0, iw, hmax, oy = wins[i]
            band = _paste_add(band, im * feather_w[i][None], oy, x0)
        return band
    if plan.blend_kind == "multiband":
        cdt = jnp.dtype(plan.compute_dtype)

        def down(z):
            _, hh, ww = z.shape
            if hh in plan.down_mats and ww in plan.down_mats:
                return pyr_down_mm(
                    z, plan.down_mats[hh], plan.down_mats[ww]
                ).astype(cdt)
            from ..ops.pyramid import pyr_down

            return pyr_down(z.astype(jnp.float32)).astype(cdt)

        def up(z):
            _, hh, ww = z.shape
            if hh in plan.up_mats and ww in plan.up_mats:
                return pyr_up_mm(z, plan.up_mats[hh], plan.up_mats[ww]).astype(
                    cdt
                )
            from ..ops.pyramid import pyr_up

            return pyr_up(z.astype(jnp.float32)).astype(cdt)

        if coarse is not None:
            return _blend_windows_split(
                plan, imgs, wins, weight_pyrs, inv_bw, B, ext_v, W_v,
                down, up, cdt, coarse,
            )

        dst = [
            jnp.zeros((c, ext_v >> l, W_v >> l), dtype=cdt)
            for l in range(B + 1)
        ]
        for i, wd in enumerate(imgs):
            x0, iw, hmax, oy = wins[i]
            gauss = [wd]
            for _ in range(B):
                gauss.append(down(gauss[-1]))
            for l in range(B + 1):
                lap = gauss[l] - up(gauss[l + 1]) if l < B else gauss[B]
                contrib = lap * weight_pyrs[l][i][None]
                dst[l] = _paste_add(
                    dst[l],
                    contrib,
                    oy >> l if isinstance(oy, int) else oy // (1 << l),
                    x0 >> l,
                )
        for l in range(B + 1):
            dst[l] = dst[l] * inv_bw[l][None]
        band = dst[B]
        for l in range(B - 1, -1, -1):
            band = up(band) + dst[l]
        return band
    # blend_kind == "none": averaged paste
    band = jnp.zeros((c, ext_v, W_v), dtype=jnp.float32)
    total = jnp.zeros((1, ext_v, W_v), dtype=jnp.float32)
    for i, im in enumerate(imgs):
        x0, iw, hmax, oy = wins[i]
        band = _paste_add(band, im.astype(jnp.float32), oy, x0)
        total = _paste_add(
            total, (im != 0).any(axis=0)[None].astype(jnp.float32), oy, x0
        )
    return band / jnp.maximum(total, 1.0)


def _blend_windows_split(
    plan, imgs, wins, wp_fine, inv_fine, B, ext_v, W_v, down, up, cdt, co
):
    """Two-level multiband blend (communication-avoiding halos).

    Fine levels 0..L-1 run band-locally exactly like the single-level
    path (their support fits the 5*2^L halo).  The level-L Gaussian's
    band-INTERIOR rows are all-gathered across 'space' (the only image
    bytes the sharded stitch ever exchanges — a few hundred KB at 4K),
    and every chip redundantly computes the tiny global coarse levels
    L..B, collapses them to the global level-L reconstruction, and
    gathers its own extended-band rows back (precomputed reflect-101
    row map) to seed the band-local fine collapse.

    The dyadic pyramid's locality makes this exact for band-interior
    outputs: fine-level boundary effects stay within the halo, and the
    coarse path is computed on globally complete data."""
    L = co["L"]
    halo_v, bh_v = co["halo"], co["bh"]
    c = imgs[0].shape[0]

    dst = [
        jnp.zeros((c, ext_v >> l, W_v >> l), dtype=cdt) for l in range(L)
    ]
    g_slices = []
    for i, wd in enumerate(imgs):
        x0, iw, hmax, oy = wins[i]
        gauss = [wd]
        for _ in range(L):
            gauss.append(down(gauss[-1]))
        for l in range(L):
            lap = gauss[l] - up(gauss[l + 1])
            contrib = lap * wp_fine[l][i][None]
            dst[l] = _paste_add(
                dst[l],
                contrib,
                oy >> l if isinstance(oy, int) else oy // (1 << l),
                x0 >> l,
            )
        # band-interior rows of gauss[L] (window pasted into the
        # extended band first so a short window never under-covers)
        buf = jnp.zeros((c, ext_v >> L, iw >> L), dtype=cdt)
        buf = _paste_add(
            buf,
            gauss[L],
            oy >> L if isinstance(oy, int) else oy // (1 << L),
            0,
        )
        g_slices.append(buf[:, (halo_v >> L) : (halo_v >> L) + (bh_v >> L)])

    widths = [g.shape[-1] for g in g_slices]
    cat = jnp.concatenate(g_slices, axis=-1)
    full = jax.lax.all_gather(
        cat, "space", axis=1, tiled=True
    )  # [c, Hp_v>>L, sum(iw>>L)]
    expected = co["S"] * (bh_v >> L)
    if full.shape[1] != expected:
        # a mesh whose all-gather comes up short must fail loudly, never
        # emit plausible-looking partial frames
        raise ValueError(
            f"split blend all-gather returned {full.shape[1]} "
            f"level-{L} rows, expected {expected} "
            f"(S={co['S']} x {bh_v >> L}): the mesh 'space' axis "
            "does not match the plan"
        )
    Hp_L = full.shape[1]

    nl = B - L + 1
    dstC = [
        jnp.zeros((c, (Hp_L << L) >> l, W_v >> l), dtype=cdt)
        for l in range(L, B + 1)
    ]
    off = 0
    for i in range(len(imgs)):
        x0, iw, hmax, oy = wins[i]
        g = full[:, :, off : off + widths[i]]
        off += widths[i]
        gaussC = [g]
        for l in range(L, B):
            gaussC.append(down(gaussC[-1]))
        for li, l in enumerate(range(L, B + 1)):
            lap = gaussC[li] - up(gaussC[li + 1]) if l < B else gaussC[-1]
            contrib = lap * co["wp"][li][i][None]
            dstC[li] = dstC[li].at[
                :, :, (x0 >> l) : (x0 >> l) + contrib.shape[-1]
            ].add(contrib)
    for li in range(nl):
        dstC[li] = dstC[li] * co["inv"][li][None]
    accC = dstC[-1]
    for li in range(nl - 2, -1, -1):
        accC = up(accC) + dstC[li]
    # extended-band rows of the global level-L acc
    acc = accC[:, co["ridx"]]
    for l in range(L - 1, -1, -1):
        # the fine accumulators must be normalized by the band-local
        # inverse seam weights exactly like the single-level path
        # (blenders.cpp:720-730 divide-by-band-weights before collapse);
        # skipping it is only exact where seam weights sum to 1 — a rig
        # with a coverage gap inside the union box diverges up to
        # 39/255 at gap edges otherwise (round-5 fix, partial-coverage
        # parity test in tests/test_sharded_split.py)
        acc = up(acc) + dst[l] * inv_fine[l][None]
    return acc


def _overlay_band(plan, ov_window, k, ext_v, W_v, div=1):
    """Overlay k's window pasted onto a zero extended band (halo rows
    included: they feed the output-resize taps, and interiors are
    disjoint so the duplicated halo work agrees across shards)."""
    x0, iw, hmax = plan.rois[plan.num_inputs + k]
    c = ov_window.shape[0]
    buf = jnp.zeros((c, ext_v, W_v), dtype=ov_window.dtype)
    return _paste_add(
        buf, ov_window, _win_oy(plan, plan.num_inputs + k, div=div), x0 // div
    )


def _stitch_band(plan: ShardedPlan, frames, out_format, gains_in=None):
    """One frame set on one shard.  frames: per-input list of
    [Hi*3/2, Wi] u8 (packed YUV420P, or NV12 when
    plan.frame_format == "nv12").  ``gains_in`` ([ncam] f32, optional)
    injects another output's solved exposure gains and skips the
    pairwise solve — the cross-output gain-sharing semantics
    (async.cpp:75-91, exposure_compensate.cpp:315-327); mirrors the
    single-chip Mapper.stitch(gains=).  Returns (band output, gains):

    * ``out_format="yuv420p"``: packed band output, u8 [obh*3/2, oW]
      (YUV420P, or NV12 when frame_format == "nv12")
    * ``out_format="rgb"``: f32 [3, obh, oW]
    """
    ncam = plan.num_inputs
    ntotal = ncam + plan.num_overlays
    ext, Wp, halo, bh = plan.ext, plan.Wp, plan.halo, plan.bh

    warped = []
    for i in range(ntotal):
        buf = frames[i]
        if plan.frame_format == "nv12":
            buf = merge_yuv420p(*split_nv12(buf))
        rgb = yuv420p_to_rgb_planar(
            buf, up_cols=plan.chroma_up[buf.shape[1]]
        )
        rgb = jnp.clip(rgb * plan.vignette[i][None], 0.0, 255.0)
        # [3, hmax_i, iw_i] (window-sized)
        warped.append(
            remap_apply_packed(
                pack_planes(rgb), plan.remaps[i], nc=3,
                out_dtype=gather_dtype(
                    plan.blend_kind, plan.compute_dtype, i, plan.num_inputs
                ),
            )
        )

    # exposure gains: working-grid box means (identical global block
    # grid to the single-chip Mapper), psum'd across 'space'
    gains = jnp.ones((ncam,), dtype=jnp.float32)
    pairwise = plan.gm_i is not None and plan.pairs
    need_norms = (pairwise and gains_in is None) or (
        plan.gain_blocks is not None
    )
    if need_norms:
        norms = [
            _window_norm_grid(
                plan,
                warped[i],
                i,
                lambda x: jnp.sqrt(jnp.sum(x * x, axis=0)),
            )
            for i in range(ncam)
        ]
    if plan.gain_blocks is not None:
        lattice = _solve_band_block_lattice(plan, norms)
        warped[:ncam] = [
            wd
            * _sample_lattice_window(plan, lattice, i)[None].astype(
                wd.dtype
            )
            for i, wd in enumerate(warped[:ncam])
        ]
    elif pairwise:
        gains = (
            gains_in.astype(jnp.float32)
            if gains_in is not None
            else _solve_band_gains(plan, norms)
        )
        # cast the scalar, not the image: f32*bf16 would promote the
        # whole warped image back to f32
        warped[:ncam] = [
            wd * gains[i].astype(wd.dtype)
            for i, wd in enumerate(warped[:ncam])
        ]

    wins = [
        plan.rois[i] + (_win_oy(plan, i),) for i in range(ncam)
    ]
    coarse = None
    if plan.split_level >= 0 and plan.blend_kind == "multiband":
        coarse = dict(
            L=plan.split_level,
            wp=plan.wp_coarse,
            inv=plan.inv_bw_coarse,
            ridx=plan.coarse_row_idx,
            halo=halo,
            bh=bh,
            S=plan.S,
        )
    band = _blend_windows(
        plan,
        warped[:ncam],
        wins,
        plan.weight_pyrs,
        plan.inv_band_weights,
        plan.feather_w,
        plan.num_bands,
        ext,
        Wp,
        coarse=coarse,
    )
    band = band.astype(jnp.float32)
    if plan.union_row_mask is not None:
        band = (
            band
            * plan.union_row_mask[None, :, None]
            * plan.union_col_mask[None, None, :]
        )

    # overlay paste (mapper.cpp:279-282 semantics), extended-band rows
    for k in range(plan.num_overlays):
        ov = _overlay_band(
            plan, warped[ncam + k].astype(jnp.float32), k, ext, Wp
        )
        m = plan.overlay_masks[k][None]
        band = band * (1.0 - m) + ov * m

    band = jnp.clip(band, 0.0, 255.0)
    if plan.resize_v is not None:
        # output resize (mapper.cpp:285-311): each shard emits its own
        # output-row slice from its extended rows
        out_img = _resize_band(band, plan.resize_v, plan.resize_h)
    else:
        out_img = band[:, halo : halo + bh]
    if out_format == "rgb":
        return out_img, gains
    out = rgb_planar_to_yuv420p(out_img, down_cols=plan.chroma_down)
    if plan.frame_format == "nv12":
        out = merge_nv12(*split_yuv420p(out))
    return out, gains


def _stitch_band_yuv(plan: ShardedPlan, frames, out_format, gains_in=None):
    """YUV420-native band stitch (see stitch/yuv_mode.py): the luma plane
    gathered at full band resolution (nc=1) and U|V packed into one
    plane gathered at half resolution (nc=2), per-plane window blends,
    centered chroma, packed YUV420P (or NV12) band output.  frames:
    per-input list of [Hi*3/2, Wi] u8.  ``gains_in`` ([ncam] f32,
    optional) injects another output's solved gains and skips the
    pairwise solve (async.cpp:75-91 cross-output sharing)."""
    assert out_format == "yuv420p"
    ntotal = plan.num_inputs + plan.num_overlays
    warped_y, warped_uv = [], []
    for i in range(ntotal):
        buf = frames[i]
        if plan.frame_format == "nv12":
            y, u, v = split_nv12(buf)
        else:
            y, u, v = split_yuv420p(buf)
        yf = jnp.clip(y.astype(jnp.float32) * plan.vignette[i], 0.0, 255.0)
        vh = plan.vignette_half[i]
        uf = jnp.clip((u.astype(jnp.float32) - 128.0) * vh + 128.0, 0.0, 255.0)
        vf = jnp.clip((v.astype(jnp.float32) - 128.0) * vh + 128.0, 0.0, 255.0)
        dt = gather_dtype(plan.blend_kind, plan.compute_dtype, i, plan.num_inputs)
        # per input [1, hmax_i, iw_i] and [2, hmax_i/2, iw_i/2]
        warped_y.append(
            remap_apply_packed(pack_planes([yf]), plan.remaps[i], nc=1, out_dtype=dt)
        )
        warped_uv.append(
            remap_apply_packed(
                pack_planes([uf, vf]), plan.remaps_uv[i], nc=2, out_dtype=dt
            )
        )
    return _postwarp_band_yuv(
        plan, warped_y, warped_uv, gains_in, out_format
    )


def _postwarp_band_yuv(plan: ShardedPlan, warped_y, warped_uv, gains_in,
                       out_format):
    """Everything after the gathers: chroma centering, gains, per-plane
    window blends, overlays, resize, packed band output."""
    ncam = plan.num_inputs
    ext, Wp, halo, bh = plan.ext, plan.Wp, plan.halo, plan.bh
    bh2, halo2 = bh // 2, halo // 2
    Wp2 = Wp // 2
    # centered chroma: covered pixels carry (U-128, V-128); uncovered
    # stay 0 and become neutral 128 at the output stage
    warped_uv = [w - jnp.asarray(128.0, w.dtype) for w in warped_uv]

    gains = jnp.ones((ncam,), dtype=jnp.float32)
    pairwise = plan.gm_i is not None and plan.pairs
    need_norms = (pairwise and gains_in is None) or (
        plan.gain_blocks is not None
    )
    if need_norms:
        # exact elementNorm (gpu_mat.cu:444-485): RGB L2 norm from
        # pooled luma + pooled centered chroma on the working grid
        norms = [
            _window_norm_grid_yuv(plan, warped_y[i], warped_uv[i], i)
            for i in range(ncam)
        ]
    if plan.gain_blocks is not None:
        # one lattice solve, two sample grids: luma-grid maps and
        # half-resolution chroma-grid maps (stitch/mapper.py:697-721)
        lattice = _solve_band_block_lattice(plan, norms)
        for i in range(ncam):
            gy = _sample_lattice_window(plan, lattice, i)
            guv = _sample_lattice_window(plan, lattice, i, div=2)
            warped_y[i] = warped_y[i] * gy[None].astype(warped_y[i].dtype)
            warped_uv[i] = warped_uv[i] * guv[None].astype(
                warped_uv[i].dtype
            )
    elif pairwise:
        gains = (
            gains_in.astype(jnp.float32)
            if gains_in is not None
            else _solve_band_gains(plan, norms)
        )
        warped_y[:ncam] = [
            w * gains[i].astype(w.dtype)
            for i, w in enumerate(warped_y[:ncam])
        ]
        warped_uv[:ncam] = [
            w * gains[i].astype(w.dtype)
            for i, w in enumerate(warped_uv[:ncam])
        ]

    wins = [plan.rois[i] + (_win_oy(plan, i),) for i in range(ncam)]
    wins_uv = [
        (
            plan.rois[i][0] // 2,
            plan.rois[i][1] // 2,
            plan.rois[i][2] // 2,
            _win_oy(plan, i, div=2),
        )
        for i in range(ncam)
    ]

    coarse_y = coarse_uv = None
    if plan.blend_kind == "multiband":
        if plan.split_level >= 0:
            coarse_y = dict(
                L=plan.split_level,
                wp=plan.wp_coarse,
                inv=plan.inv_bw_coarse,
                ridx=plan.coarse_row_idx,
                halo=halo,
                bh=bh,
                S=plan.S,
                )
        if plan.split_level_uv >= 0:
            coarse_uv = dict(
                L=plan.split_level_uv,
                wp=plan.wp_coarse_uv,
                inv=plan.inv_bw_coarse_uv,
                ridx=plan.coarse_row_idx_uv,
                halo=halo2,
                bh=bh2,
                S=plan.S,
                )
    band_y = _blend_windows(
        plan,
        warped_y[:ncam],
        wins,
        plan.weight_pyrs,
        plan.inv_band_weights,
        plan.feather_w,
        plan.num_bands,
        ext,
        Wp,
        coarse=coarse_y,
    )
    band_uv = _blend_windows(
        plan,
        warped_uv[:ncam],
        wins_uv,
        plan.weight_pyrs_uv,
        plan.inv_band_weights_uv,
        plan.feather_w_uv,
        plan.num_bands_uv,
        ext // 2,
        Wp2,
        coarse=coarse_uv,
    )

    band_yf = band_y.astype(jnp.float32)
    band_uvf = band_uv.astype(jnp.float32)
    if plan.union_row_mask is not None:
        band_yf = (
            band_yf
            * plan.union_row_mask[None, :, None]
            * plan.union_col_mask[None, None, :]
        )
        band_uvf = (
            band_uvf
            * plan.union_row_mask_uv[None, :, None]
            * plan.union_col_mask_uv[None, None, :]
        )

    # overlay paste (mapper.cpp:279-282 semantics), Y and centered UV,
    # on the extended-band rows
    for k in range(plan.num_overlays):
        ovy = _overlay_band(
            plan, warped_y[ncam + k].astype(jnp.float32), k, ext, Wp
        )
        m = plan.overlay_masks[k][None]
        band_yf = band_yf * (1.0 - m) + ovy * m
        ovuv = _overlay_band(
            plan, warped_uv[ncam + k].astype(jnp.float32), k,
            ext // 2, Wp2, div=2,
        )
        m2 = plan.overlay_masks_uv[k][None]
        band_uvf = band_uvf * (1.0 - m2) + ovuv * m2

    if plan.resize_v is not None:
        # output resize in the native planes (mapper.cpp:285-311): Y at
        # full res, chroma at half res, each from its extended band rows
        out_y = _resize_band(band_yf, plan.resize_v, plan.resize_h)
        out_uv = _resize_band(
            band_uvf, plan.resize_v_uv, plan.resize_h_uv
        )
    else:
        out_y = band_yf[:, halo : halo + bh]
        out_uv = band_uvf[:, halo2 : halo2 + bh2]

    y8 = jnp.clip(jnp.round(out_y[0]), 0, 255).astype(jnp.uint8)
    u8 = jnp.clip(jnp.round(out_uv[0] + 128.0), 0, 255).astype(jnp.uint8)
    v8 = jnp.clip(jnp.round(out_uv[1] + 128.0), 0, 255).astype(jnp.uint8)
    if plan.frame_format == "nv12":
        return merge_nv12(y8, u8, v8), gains
    return merge_yuv420p(y8, u8, v8), gains


class ShardedMapper:
    """Stitch batches of frame sets over a ('data', 'space') mesh.

    Same product as the single-chip ``Mapper`` (mapper.cpp:47-311
    semantics): per-input packed remap gathers, pairwise or blocks
    gains, multiband/feather blend, overlays, scale_output resize,
    YUV420P or NV12 frames.  ``pipeline=None`` picks yuv420 whenever the
    output format and geometry allow it, like the Mapper's "auto"."""

    def __init__(
        self,
        mt: MapperTemplate,
        in_sizes,
        mesh: Mesh,
        blend: int = 128,
        enable_gain: bool = True,
        out_format: str = "yuv420p",
        blend_dtype: str = DEFAULT_BLEND_DTYPE,
        pipeline: str = None,
        scale_output=None,
        frame_format: str = "yuv420p",
        coarse_split=None,
    ):
        assert out_format in ("yuv420p", "rgb")
        W0, H0 = mt.out_size
        osz = tuple(scale_output) if scale_output else (W0, H0)
        if pipeline is None:
            # the YUV420-native pipeline whenever the output format and
            # geometry allow it; rgb output or odd geometry use rgb
            even = all(h % 2 == 0 and w % 2 == 0 for h, w in in_sizes)
            pipeline = (
                "yuv420"
                if out_format == "yuv420p"
                and even
                and W0 % 2 == 0
                and H0 % 2 == 0
                and osz[0] % 2 == 0
                and osz[1] % 2 == 0
                else "rgb"
            )
        assert pipeline == "rgb" or out_format == "yuv420p"
        self.mesh = mesh
        self.out_format = out_format
        S = mesh.shape["space"]
        self.plan = build_sharded_plan(
            mt,
            in_sizes,
            S,
            blend=blend,
            enable_gain=enable_gain,
            blend_dtype=blend_dtype,
            pipeline=pipeline,
            scale_output=scale_output,
            frame_format=frame_format,
            coarse_split=coarse_split,
        )

        # per-leaf specs: S-leading leaves shard over 'space', the rest
        # replicate
        sharded_leaves = set()
        for f in _SPACE_FIELDS:
            v = getattr(self.plan, f)
            if v is not None:
                for leaf in jax.tree.leaves(v):
                    sharded_leaves.add(id(leaf))

        def leaf_spec(leaf):
            return P("space") if id(leaf) in sharded_leaves else P()

        plan_specs = jax.tree.map(leaf_spec, self.plan)
        self._plan_dev = jax.device_put(
            self.plan,
            jax.tree.map(
                lambda spec: NamedSharding(mesh, spec), plan_specs
            ),
        )

        from jax import shard_map

        out_spec = (
            P("data", "space", None)
            if out_format == "yuv420p"
            else P("data", None, "space", None)
        )

        ntotal = self.plan.num_inputs + self.plan.num_overlays

        def run_bands(plan_local, get_set, nb, get_gains=None):
            # strip the local S axis (== 1) off space-sharded leaves only
            plan_sq = jax.tree.map(
                lambda leaf, spec: leaf[0] if spec == P("space") else leaf,
                plan_local,
                plan_specs,
            )
            # static unroll over the (small) per-device batch
            band_fn = (
                _stitch_band_yuv
                if plan_sq.pipeline == "yuv420"
                else _stitch_band
            )
            outs, gains = [], []
            for b in range(nb):
                o, g = band_fn(
                    plan_sq,
                    get_set(b),
                    out_format,
                    gains_in=None if get_gains is None else get_gains(b),
                )
                outs.append(o)
                gains.append(g)
            return jnp.stack(outs), jnp.stack(gains)

        frame_specs = tuple(P("data") for _ in range(ntotal))

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(plan_specs, frame_specs),
            out_specs=(out_spec, P("data", None)),
            check_vma=False,
        )
        def step(plan_local, frames_local):
            return run_bands(
                plan_local,
                lambda b: [f[b] for f in frames_local],
                frames_local[0].shape[0],
            )

        self._step = jax.jit(step)

        # gains-injecting variant (cross-output sharing, async.cpp:75-91
        # + exposure_compensate.cpp:315-327): gains [B, ncam] rides the
        # 'data' axis like the frames, replicated over 'space'; compiles
        # lazily on first use so solve-only users never pay for it
        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(plan_specs, frame_specs, P("data")),
            out_specs=(out_spec, P("data", None)),
            check_vma=False,
        )
        def step_gains(plan_local, frames_local, gains_local):
            return run_bands(
                plan_local,
                lambda b: [f[b] for f in frames_local],
                frames_local[0].shape[0],
                get_gains=lambda b: gains_local[b],
            )

        self._step_gains = jax.jit(step_gains)

        # stacked-input variant (equal sizes): the multihost path feeds
        # one global [B, ntotal, H*3/2, W] array built with
        # make_array_from_process_local_data, which cannot be sliced
        # per input outside jit
        self._step_stacked = None
        if len(set(map(tuple, in_sizes))) == 1:

            @partial(
                shard_map,
                mesh=mesh,
                in_specs=(plan_specs, P("data")),
                out_specs=(out_spec, P("data", None)),
                check_vma=False,
            )
            def step_stacked(plan_local, frames_local):
                return run_bands(
                    plan_local,
                    lambda b: [
                        frames_local[b, i] for i in range(ntotal)
                    ],
                    frames_local.shape[0],
                )

            self._step_stacked = jax.jit(step_stacked)

    def stitch_batch(self, frames, gains=None):
        """frames: per-input list of [B, Hi*3/2, Wi] u8 arrays (B
        divisible by mesh 'data'), or a single stacked
        [B, ncam(+nov), Hf*3/2, Wf] array when all sizes are equal.
        ``gains`` ([B, ncam] f32, optional): inject another output's
        solved per-frame exposure gains and skip the pairwise solve —
        the cross-output gain-sharing semantics (async.cpp:75-91,
        gain_modes encoding async.hpp:79); mirrors the single-chip
        ``Mapper.stitch(gains=)``.
        Returns (out, gains):

        * yuv420p: u8 [B, S*obh*3/2, oW] — per-band packed YUV420P (or
          NV12) buffers stacked along rows, sharded (data, space); pass
          through :meth:`assemble_yuv` for the canonical [oh*3/2, ow]
          buffer.
        * rgb: f32 [B, 3, S*obh, oW] sharded (data, space).
        """
        ntotal = self.plan.num_inputs + self.plan.num_overlays
        if not isinstance(frames, (list, tuple)):
            assert self._step_stacked is not None, (
                "stacked input needs equal camera sizes; pass a "
                "per-input list for mixed-size rigs"
            )
            assert gains is None, (
                "gain injection needs the per-input-list path"
            )
            return self._step_stacked(self._plan_dev, jnp.asarray(frames))
        frames = tuple(jnp.asarray(f) for f in frames)
        assert len(frames) == ntotal
        if gains is not None:
            g = jnp.asarray(gains, dtype=jnp.float32)
            assert g.ndim == 2 and g.shape[1] == self.plan.num_inputs, (
                f"gains must be [B, {self.plan.num_inputs}], got {g.shape}"
            )
            return self._step_gains(self._plan_dev, frames, g)
        return self._step(self._plan_dev, frames)

    def assemble_yuv(self, out_b):
        """Reassemble one frame's per-band YUV420P/NV12 stack
        ([S*obh*3/2, oW]) into the canonical packed [oh*3/2, ow]
        buffer (same frame format)."""
        ow, oh = self.plan.out_size
        S, obh, oW = self.plan.S, self.plan.obh, self.plan.oW
        nv12 = self.plan.frame_format == "nv12"
        bands = np.asarray(out_b).reshape(S, obh * 3 // 2, oW)
        ys, us, vs = [], [], []
        for s in range(S):
            y, u, v = (split_nv12 if nv12 else split_yuv420p)(bands[s])
            ys.append(np.asarray(y))
            us.append(np.asarray(u))
            vs.append(np.asarray(v))
        y = np.concatenate(ys)[:oh, :ow]
        u = np.concatenate(us)[: oh // 2, : ow // 2]
        v = np.concatenate(vs)[: oh // 2, : ow // 2]
        if nv12:
            return np.asarray(
                merge_nv12(
                    jnp.asarray(y), jnp.asarray(u), jnp.asarray(v)
                )
            )
        bottom = np.concatenate([u, v], axis=1)
        return np.concatenate([y, bottom], axis=0)
