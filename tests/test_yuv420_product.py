"""The yuv420 pipeline as a full product (VERDICT r2 item 4): mixed
camera sizes, blocks-gain, and scaled output — capabilities the
reference Mapper provides uniformly (octvr/src/mapper.cpp:47-191,
285-311) and that the fast path must therefore also carry."""

import math

import numpy as np
import pytest

from octvr_tpu.stitch import Mapper
from octvr_tpu.template import compile_rig
from rigs import two_fisheye_rig
from test_stitch import (
    ground_truth,
    render_camera_frames,
    rgb_from_yuv_buf,
)

PI = math.pi


def mixed_size_rig():
    """Two opposing fisheyes with DIFFERENT sensor sizes (1200 vs 1000)."""
    rig = two_fisheye_rig()
    rig["inputs"][1]["options"]["width"] = 1000
    rig["inputs"][1]["options"]["height"] = 1000
    return rig


@pytest.fixture(scope="module")
def two_cam_setup():
    rig = two_fisheye_rig()
    mt = compile_rig(rig, 512, 256)
    mt.create_masks()
    sizes = [
        (s["options"]["height"], s["options"]["width"])
        for s in rig["inputs"]
    ]
    return rig, mt, sizes


@pytest.fixture(scope="module")
def mixed_setup():
    rig = mixed_size_rig()
    mt = compile_rig(rig, 512, 256)
    mt.create_masks()
    sizes = [
        (s["options"]["height"], s["options"]["width"])
        for s in rig["inputs"]
    ]
    return rig, mt, sizes


def test_yuv420_mixed_camera_sizes(mixed_setup):
    """Unequal camera sizes run the yuv420 path with one gather per
    input at its own source size; output matches the rgb path and the
    analytic world to the same bars as the equal-size test."""
    rig, mt, sizes = mixed_setup
    assert len(set(sizes)) == 2  # genuinely mixed
    frames = render_camera_frames(rig)

    m_rgb = Mapper(mt, sizes, blend=16, enable_gain=True, pipeline="rgb")
    m_yuv = Mapper(mt, sizes, blend=16, enable_gain=True, pipeline="yuv420")
    assert len({ip.remap.in_shape for ip in m_yuv.plan.inputs}) == 2
    assert len({ip.remap_uv.in_shape for ip in m_yuv.plan.inputs}) == 2
    out_rgb, g_rgb = m_rgb.stitch(frames)
    out_yuv, g_yuv = m_yuv.stitch(frames)

    h = out_rgb.shape[0] * 2 // 3
    y_err = np.abs(
        np.asarray(out_rgb)[:h].astype(np.float32)
        - np.asarray(out_yuv)[:h].astype(np.float32)
    )
    assert y_err.mean() < 1.0, y_err.mean()
    np.testing.assert_allclose(
        np.asarray(g_yuv), np.asarray(g_rgb), rtol=0.05, atol=0.01
    )

    truth = ground_truth(512, 256)
    err = np.abs(rgb_from_yuv_buf(out_yuv) - truth)[4:-4]
    assert err.mean() < 3.0, err.mean()


def test_yuv420_blocks_gain(two_cam_setup):
    """enable_gain='blocks' on the yuv420 path: one lattice solve feeds
    luma-grid and chroma-grid gain maps; output matches the rgb
    blocks-gain path on an exposure-skewed scene."""
    rig, mt, sizes = two_cam_setup
    frames = render_camera_frames(rig, exposure_gains=[1.15, 0.85])

    m_rgb = Mapper(
        mt, sizes, blend=16, enable_gain="blocks", pipeline="rgb"
    )
    m_yuv = Mapper(
        mt, sizes, blend=16, enable_gain="blocks", pipeline="yuv420"
    )
    out_rgb, _ = m_rgb.stitch(frames)
    out_yuv, _ = m_yuv.stitch(frames)

    h = out_rgb.shape[0] * 2 // 3
    y_err = np.abs(
        np.asarray(out_rgb)[:h].astype(np.float32)
        - np.asarray(out_yuv)[:h].astype(np.float32)
    )
    assert y_err.mean() < 1.5, y_err.mean()
    c_err = np.abs(
        np.asarray(out_rgb)[h:].astype(np.float32)
        - np.asarray(out_yuv)[h:].astype(np.float32)
    )
    assert c_err.mean() < 2.5, c_err.mean()


def test_yuv420_scale_output(two_cam_setup):
    """scale_output under yuv420: Y resizes at full res, chroma at half
    res (mapper.cpp:285-311 out_size semantics); result matches the
    analytic world rendered at the scaled resolution."""
    rig, mt, sizes = two_cam_setup
    frames = render_camera_frames(rig)
    m = Mapper(
        mt,
        sizes,
        blend=16,
        enable_gain=True,
        scale_output=(256, 128),
        pipeline="yuv420",
    )
    out, _ = m.stitch(frames)
    assert out.shape == (128 * 3 // 2, 256)
    truth = ground_truth(256, 128)
    err = np.abs(rgb_from_yuv_buf(out) - truth)[4:-4]
    assert err.mean() < 4.0, err.mean()


def test_auto_defaults_cpu(two_cam_setup):
    """The defaults are one choice for every platform: pipeline='auto'
    resolves to yuv420 on even geometry and to rgb on odd geometry, and
    the blend dtype is DEFAULT_BLEND_DTYPE (the on-card regression of
    the defaults against rgb + float32: bench.py, chip_smoke.py)."""
    from octvr_tpu.stitch.mapper import DEFAULT_BLEND_DTYPE

    rig, mt, sizes = two_cam_setup
    m = Mapper(mt, sizes, blend=16)
    assert m.plan.pipeline == "yuv420"
    assert m.plan.blender.compute_dtype == DEFAULT_BLEND_DTYPE
    odd = Mapper(mt, [(h - 1, w - 1) for h, w in sizes], blend=16)
    assert odd.plan.pipeline == "rgb"
    assert odd.plan.blender.compute_dtype == DEFAULT_BLEND_DTYPE


def test_yuv420_gain_parity_saturated_chroma(two_cam_setup):
    """VERDICT r2 weak #6: the yuv420 gain norm must track the
    reference elementNorm (RGB L2, gpu_mat.cu:444-485) on SATURATED
    scenes, where the old sqrt(3)*Y gray-world approximation
    underweighted chroma-heavy exposure differences.  Saturate the
    world colors toward the RGB gamut faces, skew exposure, and
    require the yuv420-path gains to match the rgb path (which
    computes the true norm) within 2%."""
    rig, mt, sizes = two_cam_setup
    frames = render_camera_frames(rig, exposure_gains=[1.25, 0.8])
    # push chroma hard: scale U/V away from neutral by 1.9 (clipped) —
    # identical inputs feed both paths, so any gain drift is the norm
    sat = []
    for f in frames:
        h = f.shape[0] * 2 // 3
        g = f.astype(np.float32)
        g[h:] = np.clip((g[h:] - 128.0) * 1.9 + 128.0, 0.0, 255.0)
        sat.append(np.clip(np.round(g), 0, 255).astype(np.uint8))

    m_rgb = Mapper(mt, sizes, blend=16, enable_gain=True, pipeline="rgb")
    m_yuv = Mapper(mt, sizes, blend=16, enable_gain=True, pipeline="yuv420")
    _, g_rgb = m_rgb.stitch(sat)
    _, g_yuv = m_yuv.stitch(sat)
    g_rgb, g_yuv = np.asarray(g_rgb), np.asarray(g_yuv)
    assert np.abs(g_yuv / g_rgb - 1.0).max() < 0.02, (g_yuv, g_rgb)
    # and the gains actually work: they counteract the exposure skew
    assert g_rgb[0] < 1.0 < g_rgb[1]
