"""ShardedMapper product parity with the single-chip Mapper (VERDICT r3
next #2): the sharded path must carry the SAME product surface the
single-chip yuv420 pipeline grew in round 3 — mixed camera sizes via
per-size-group batched kernels, blocks-gain, scale_output, NV12 frames,
and the exact elementNorm gain behavior on saturated chroma.

Reference bar: the Mapper handles per-input sizes and output resize
uniformly (octvr/src/mapper.cpp:47-191,285-311); the per-output fan-out
shares one engine (async.cpp:247-259)."""

import numpy as np
import pytest

import jax

from octvr_tpu.ops.color import merge_nv12, split_yuv420p
from octvr_tpu.parallel.sharded import ShardedMapper, make_mesh
from octvr_tpu.stitch import Mapper
from octvr_tpu.template import compile_rig
from rigs import two_fisheye_rig
from test_stitch import render_camera_frames

import jax.numpy as jnp


def _y_mean_err(a, b, oh):
    ya = np.asarray(a)[:oh].astype(np.float32)
    yb = np.asarray(b)[:oh].astype(np.float32)
    return np.abs(ya - yb).mean()


@pytest.fixture(scope="module")
def mixed_setup():
    rig = two_fisheye_rig()
    rig["inputs"][0]["options"].update(width=256, height=256)
    rig["inputs"][1]["options"].update(width=192, height=192)
    mt = compile_rig(rig, 256, 128)
    mt.create_masks()
    sizes = [(256, 256), (192, 192)]
    frames = render_camera_frames(rig)
    return rig, mt, sizes, frames


@pytest.fixture(scope="module")
def equal_setup():
    rig = two_fisheye_rig()
    for spec in rig["inputs"]:
        spec["options"].update(width=256, height=256)
    mt = compile_rig(rig, 256, 128)
    mt.create_masks()
    sizes = [(256, 256)] * 2
    return rig, mt, sizes


def test_sharded_mixed_camera_sizes(mixed_setup):
    """Unequal camera sizes on an 8-device mesh: one gather per input at
    its own source size, as in the single-device Mapper."""
    rig, mt, sizes, frames = mixed_setup
    assert len(jax.devices()) >= 8
    mesh = make_mesh(2, 4)

    single = Mapper(mt, sizes, blend=8, enable_gain=True, pipeline="yuv420")
    out_s, g_s = single.stitch(frames)

    sm = ShardedMapper(mt, sizes, mesh, blend=8, pipeline="yuv420")
    assert len({p.in_shape for p in sm.plan.remaps}) == 2
    out_m, g_m = sm.stitch_batch(
        [np.stack([f] * 2) for f in frames]  # B=2 over data=2
    )
    np.testing.assert_allclose(
        np.asarray(g_m)[0], np.asarray(g_s), rtol=2e-3
    )
    yuv = sm.assemble_yuv(np.asarray(out_m)[0])
    assert yuv.shape == np.asarray(out_s).shape
    oh = mt.out_size[1]
    assert _y_mean_err(yuv, out_s, oh) < 0.5


def test_sharded_blocks_gain(equal_setup):
    """enable_gain='blocks' on the mesh: band-partial block sums psum'd
    into one global lattice, window-sampled gain maps for luma and
    half-res chroma (exposure_compensate.cpp:330-438 role)."""
    rig, mt, sizes = equal_setup
    frames = render_camera_frames(rig, exposure_gains=[1.15, 0.85])
    mesh = make_mesh(1, 8)

    single = Mapper(
        mt, sizes, blend=8, enable_gain="blocks", pipeline="yuv420"
    )
    out_s, _ = single.stitch(frames)

    sm = ShardedMapper(
        mt, sizes, mesh, blend=8, enable_gain="blocks", pipeline="yuv420"
    )
    assert sm.plan.gain_blocks is not None
    out_m, _ = sm.stitch_batch(np.stack([np.stack(frames)]))
    yuv = sm.assemble_yuv(np.asarray(out_m)[0])
    oh = mt.out_size[1]
    assert _y_mean_err(yuv, out_s, oh) < 0.75
    c_err = np.abs(
        np.asarray(yuv)[oh:].astype(np.float32)
        - np.asarray(out_s)[oh:].astype(np.float32)
    ).mean()
    assert c_err < 1.0, c_err


def test_sharded_scale_output(equal_setup):
    """scale_output on the mesh: each shard emits its own output-row
    slice from its halo-extended band; Y resizes at full res, chroma at
    half res (mapper.cpp:285-311)."""
    rig, mt, sizes = equal_setup
    frames = render_camera_frames(rig)
    mesh = make_mesh(1, 4)

    single = Mapper(
        mt, sizes, blend=8, enable_gain=True,
        scale_output=(128, 64), pipeline="yuv420",
    )
    out_s, _ = single.stitch(frames)
    assert np.asarray(out_s).shape == (64 * 3 // 2, 128)

    sm = ShardedMapper(
        mt, sizes, mesh, blend=8, scale_output=(128, 64),
        pipeline="yuv420",
    )
    out_m, _ = sm.stitch_batch(np.stack([np.stack(frames)]))
    yuv = sm.assemble_yuv(np.asarray(out_m)[0])
    assert yuv.shape == np.asarray(out_s).shape
    assert _y_mean_err(yuv, out_s, 64) < 0.5
    c_err = np.abs(
        np.asarray(yuv)[64:].astype(np.float32)
        - np.asarray(out_s)[64:].astype(np.float32)
    ).mean()
    assert c_err < 0.75, c_err


def test_sharded_nv12_frames(equal_setup):
    """frame_format='nv12' end to end on the mesh: NV12 camera frames
    in, NV12 band buffers out (the FastMapper frame format,
    mapper_fast.cpp:27-109, available to the sharded product)."""
    rig, mt, sizes = equal_setup
    frames = render_camera_frames(rig)
    nv12_frames = [
        np.asarray(merge_nv12(*split_yuv420p(jnp.asarray(f))))
        for f in frames
    ]
    mesh = make_mesh(1, 4)

    single = Mapper(
        mt, sizes, blend=8, enable_gain=True,
        frame_format="nv12", pipeline="yuv420",
    )
    out_s, _ = single.stitch(nv12_frames)

    sm = ShardedMapper(
        mt, sizes, mesh, blend=8, frame_format="nv12",
        pipeline="yuv420",
    )
    out_m, _ = sm.stitch_batch(np.stack([np.stack(nv12_frames)]))
    nv = sm.assemble_yuv(np.asarray(out_m)[0])
    assert nv.shape == np.asarray(out_s).shape
    oh = mt.out_size[1]
    # Y plane rows then interleaved UV rows: compare both
    assert np.abs(
        nv.astype(np.float32) - np.asarray(out_s).astype(np.float32)
    ).mean() < 0.75


def test_sharded_gain_parity_saturated_chroma(equal_setup):
    """The sharded yuv420 gain norm must track the exact RGB elementNorm
    (gpu_mat.cu:444-485) on chroma-saturated scenes — same acceptance
    as the single-chip test (test_yuv420_product.py)."""
    rig, mt, sizes = equal_setup
    frames = render_camera_frames(rig, exposure_gains=[1.25, 0.8])
    sat = []
    for f in frames:
        h = f.shape[0] * 2 // 3
        g = f.astype(np.float32)
        g[h:] = np.clip((g[h:] - 128.0) * 1.9 + 128.0, 0.0, 255.0)
        sat.append(np.clip(np.round(g), 0, 255).astype(np.uint8))
    mesh = make_mesh(1, 8)

    m_rgb = Mapper(mt, sizes, blend=8, enable_gain=True, pipeline="rgb")
    _, g_rgb = m_rgb.stitch(sat)

    sm = ShardedMapper(mt, sizes, mesh, blend=8, pipeline="yuv420")
    _, g_m = sm.stitch_batch(np.stack([np.stack(sat)]))
    g_rgb = np.asarray(g_rgb)
    g_m = np.asarray(g_m)[0]
    assert np.abs(g_m / g_rgb - 1.0).max() < 0.02, (g_m, g_rgb)
    assert g_rgb[0] < 1.0 < g_rgb[1]
