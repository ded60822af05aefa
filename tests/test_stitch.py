"""End-to-end stitch tests: full jitted pipeline vs analytic ground truth
(BASELINE configs 1 and 2)."""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from octvr_tpu.stitch import Mapper
from octvr_tpu.template import compile_rig
from rigs import (  # noqa: F401  (re-exported for the other test files)
    ground_truth,
    render_camera_frames,
    rgb_from_yuv_buf,
    six_cam_rig,
    two_fisheye_rig,
    world_color,
)

PI = math.pi


@pytest.fixture(scope="module")
def two_cam_setup():
    rig = two_fisheye_rig()
    mt = compile_rig(rig, 512, 256)
    mt.create_masks()
    sizes = [(s["options"]["height"], s["options"]["width"]) for s in rig["inputs"]]
    return rig, mt, sizes


def test_feather_stitch_matches_truth(two_cam_setup):
    rig, mt, sizes = two_cam_setup
    mapper = Mapper(mt, sizes, blend=-8, enable_gain=False)
    frames = render_camera_frames(rig)
    out, gains = mapper.stitch(frames)
    got = rgb_from_yuv_buf(np.asarray(out))
    truth = ground_truth(*mt.out_size)
    err = np.abs(got[8:-8] - truth[8:-8])  # pole rows are resolution-limited
    assert err.mean() < 3.0, f"mean err {err.mean()}"
    assert np.percentile(err, 99) < 12.0


def test_multiband_stitch_matches_truth(two_cam_setup):
    rig, mt, sizes = two_cam_setup
    mapper = Mapper(mt, sizes, blend=32, enable_gain=False)
    frames = render_camera_frames(rig)
    out, _ = mapper.stitch(frames)
    got = rgb_from_yuv_buf(np.asarray(out))
    truth = ground_truth(*mt.out_size)
    # multiband ringing at poles; compare away from extremes
    err = np.abs(got[16:-16] - truth[16:-16])
    assert err.mean() < 4.0, f"mean err {err.mean()}"


def test_no_blend_stitch(two_cam_setup):
    rig, mt, sizes = two_cam_setup
    mapper = Mapper(mt, sizes, blend=0, enable_gain=False)
    frames = render_camera_frames(rig)
    out, _ = mapper.stitch(frames)
    got = rgb_from_yuv_buf(np.asarray(out))
    truth = ground_truth(*mt.out_size)
    err = np.abs(got[8:-8] - truth[8:-8])
    assert err.mean() < 4.0


def test_gain_compensation_equalizes(two_cam_setup):
    """Feed frames with mismatched exposures; gains must counteract the
    imbalance (ratio ~ inverse exposure ratio)."""
    rig, mt, sizes = two_cam_setup
    mapper = Mapper(mt, sizes, blend=-8, enable_gain=True)
    frames = render_camera_frames(rig, exposure_gains=[1.0, 0.6])
    out, gains = mapper.stitch(frames)
    g = np.asarray(gains)
    assert g.shape == (2,)
    # camera 1 is darker -> must be boosted relative to camera 0
    assert g[1] / g[0] > 1.15
    # the solver balances cameras against each other (beta prior toward 1,
    # exposure_compensate.cpp:278-296) -- so the *ratio* of region
    # brightness must move toward 1, not the absolute level
    mapper_off = Mapper(mt, sizes, blend=-8, enable_gain=False)
    out_off, _ = mapper_off.stitch(frames)
    got = rgb_from_yuv_buf(np.asarray(out))
    got_off = rgb_from_yuv_buf(np.asarray(out_off))

    def region_ratio(img):
        cam0 = img[64:192, 224:288].mean()  # lon ~ 0: pure camera 0
        cam1 = img[64:192, :32].mean()  # lon ~ -pi: pure camera 1
        return cam0 / cam1

    truth_ratio = region_ratio(ground_truth(*mt.out_size))
    assert abs(region_ratio(got) - truth_ratio) < abs(
        region_ratio(got_off) - truth_ratio
    )


def test_gain_reuse(two_cam_setup):
    """External gains (multi-output sharing, async.hpp:79) are honored."""
    rig, mt, sizes = two_cam_setup
    mapper = Mapper(mt, sizes, blend=-8, enable_gain=True)
    frames = render_camera_frames(rig)
    ext = np.array([1.3, 0.7], dtype=np.float32)
    out, gains = mapper.stitch(frames, gains=ext)
    np.testing.assert_allclose(np.asarray(gains), ext, atol=1e-6)


def test_scaled_output(two_cam_setup):
    rig, mt, sizes = two_cam_setup
    mapper = Mapper(mt, sizes, blend=-8, enable_gain=False, scale_output=(256, 128))
    frames = render_camera_frames(rig)
    out, _ = mapper.stitch(frames)
    assert np.asarray(out).shape == (192, 256)


def test_six_cam_multiband():
    rig = six_cam_rig()
    mt = compile_rig(rig, 384, 192)
    mt.create_masks()
    sizes = [(s["options"]["height"], s["options"]["width"]) for s in rig["inputs"]]
    mapper = Mapper(mt, sizes, blend=16, enable_gain=True)
    frames = render_camera_frames(rig)
    out, gains = mapper.stitch(frames)
    got = rgb_from_yuv_buf(np.asarray(out))
    truth = ground_truth(*mt.out_size)
    err = np.abs(got[8:-8] - truth[8:-8])
    assert err.mean() < 6.0, f"mean err {err.mean()}"
    # equal-exposure world -> gains ~ 1
    np.testing.assert_allclose(np.asarray(gains), 1.0, atol=0.05)


def test_blocks_gain_compensation(two_cam_setup):
    """BlocksGainCompensator-style per-block gain maps equalize a
    spatially-varying exposure difference."""
    rig, mt, sizes = two_cam_setup
    mapper = Mapper(mt, sizes, blend=-8, enable_gain="blocks")
    frames = render_camera_frames(rig, exposure_gains=[1.0, 0.7])
    out, _ = mapper.stitch(frames)
    got = rgb_from_yuv_buf(np.asarray(out))

    mapper_off = Mapper(mt, sizes, blend=-8, enable_gain=False)
    out_off, _ = mapper_off.stitch(frames)
    got_off = rgb_from_yuv_buf(np.asarray(out_off))

    def region_ratio(img):
        cam0 = img[64:192, 224:288].mean()
        cam1 = img[64:192, :32].mean()
        return cam0 / cam1

    truth_ratio = region_ratio(ground_truth(*mt.out_size))
    assert abs(region_ratio(got) - truth_ratio) < abs(
        region_ratio(got_off) - truth_ratio
    )


def test_fast_mapper_nv12(two_cam_setup):
    """FastMapper profile: NV12 in/out, feather blend (mapper_fast.cpp)."""
    from octvr_tpu.ops.color import (
        merge_nv12,
        nv12_to_rgb,
        split_yuv420p,
    )
    from octvr_tpu.stitch import FastMapper

    rig, mt, sizes = two_cam_setup
    fm = FastMapper(mt, sizes, border=8)
    frames = render_camera_frames(rig)
    nv12 = [
        np.asarray(merge_nv12(*split_yuv420p(jnp.asarray(f)))) for f in frames
    ]
    out = fm.stitch_nv12(nv12)
    got = np.asarray(nv12_to_rgb(jnp.asarray(np.asarray(out))))
    truth = ground_truth(*mt.out_size)
    err = np.abs(got[8:-8] - truth[8:-8])
    assert err.mean() < 3.5, f"mean err {err.mean()}"


def test_multiband_bf16_matches_f32(two_cam_setup):
    """The opt-in bf16 pyramid path must track the f32 path to well
    under one 8-bit level on average (the reference's own GPU blender is
    16-bit fixed point, blenders.cpp CV_16S)."""
    rig, mt, sizes = two_cam_setup
    frames = render_camera_frames(rig)
    m16 = Mapper(
        mt, sizes, blend=32, enable_gain=True, blend_dtype="bfloat16"
    )
    m32 = Mapper(mt, sizes, blend=32, enable_gain=True, blend_dtype="float32")
    got16 = rgb_from_yuv_buf(np.asarray(m16.stitch(frames)[0]))
    got32 = rgb_from_yuv_buf(np.asarray(m32.stitch(frames)[0]))
    diff = np.abs(got16.astype(np.float32) - got32.astype(np.float32))
    assert diff.mean() < 1.0, f"mean bf16 drift {diff.mean()}"
    assert np.percentile(diff, 99.9) <= 4.0


def test_yuv420_pipeline_matches_rgb(two_cam_setup):
    """pipeline='yuv420' (full-res 1-channel Y fan + half-res 2-channel
    chroma fan, separate blends, direct YUV420P output — the reference
    FastMapper's half-res chroma approach, mapper_fast.cpp:27-109) vs
    the RGB pipeline: same luma up to rounding, chroma within the 4:2:0
    resampling difference."""
    rig, mt, sizes = two_cam_setup
    frames = render_camera_frames(rig)

    m_rgb = Mapper(mt, sizes, blend=16, enable_gain=True)
    m_yuv = Mapper(mt, sizes, blend=16, enable_gain=True, pipeline="yuv420")
    out_rgb, g_rgb = m_rgb.stitch(frames)
    out_yuv, g_yuv = m_yuv.stitch(frames)

    h = out_rgb.shape[0] * 2 // 3
    y_err = np.abs(
        np.asarray(out_rgb)[:h].astype(np.float32)
        - np.asarray(out_yuv)[:h].astype(np.float32)
    )
    assert y_err.mean() < 1.0, y_err.mean()
    c_err = np.abs(
        np.asarray(out_rgb)[h:].astype(np.float32)
        - np.asarray(out_yuv)[h:].astype(np.float32)
    )
    assert c_err.mean() < 2.0, c_err.mean()
    # gains: same solver on a luma-proxy norm — close, not identical
    np.testing.assert_allclose(
        np.asarray(g_yuv), np.asarray(g_rgb), rtol=0.05, atol=0.01
    )

    # accuracy against the analytic world (same bar as the RGB tests)
    truth = ground_truth(512, 256)
    got = rgb_from_yuv_buf(out_yuv)
    err = np.abs(got - truth)[4:-4]
    assert err.mean() < 3.0, err.mean()


def test_yuv420_pipeline_feather(two_cam_setup):
    rig, mt, sizes = two_cam_setup
    frames = render_camera_frames(rig)
    m = Mapper(mt, sizes, blend=-8, enable_gain=False, pipeline="yuv420")
    out, _ = m.stitch(frames)
    truth = ground_truth(512, 256)
    err = np.abs(rgb_from_yuv_buf(out) - truth)[4:-4]
    assert err.mean() < 3.0, err.mean()
