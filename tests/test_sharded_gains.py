"""Cross-output gain sharing on the sharded path (VERDICT r4 next #3).

The reference's multi-output semantics let output k reuse output j's
solved exposure gains per frame (async.cpp:75-91, mode encoding
async.hpp:79, export/inject exposure_compensate.cpp:315-327).  The
single-chip AsyncMultiMapper has always honored this;
``ShardedMapper.stitch_batch(gains=)`` now injects gains device-to-
device, the pipeline dispatches copiers after their owners, and
``cli/stream.py`` passes copy modes through instead of silently
rewriting them to self-solve."""

import numpy as np
import pytest

import jax

from octvr_tpu.parallel.sharded import ShardedMapper, make_mesh
from octvr_tpu.runtime import AsyncMultiMapper
from octvr_tpu.stitch import Mapper
from octvr_tpu.template import compile_rig
from rigs import two_fisheye_rig
from test_stitch import render_camera_frames


@pytest.fixture(scope="module")
def setup():
    rig = two_fisheye_rig()
    for spec in rig["inputs"]:
        spec["options"].update(width=256, height=256)
    mt = compile_rig(rig, 256, 128)
    mt.create_masks()
    sizes = [(256, 256)] * 2
    # exposure-offset feeds: the solved gains must be far from 1 so a
    # copy-vs-solve mixup cannot hide
    frames = render_camera_frames(rig, exposure_gains=[1.25, 0.8])
    return mt, sizes, frames


def test_stitch_batch_gains_injection(setup):
    """Injected gains skip the solve and match the single-chip
    Mapper.stitch(gains=) output; they are NOT the self-solve result."""
    mt, sizes, frames = setup
    assert len(jax.devices()) >= 8
    mesh = make_mesh(2, 4)

    # both paths pinned to the yuv420 pipeline: the rgb path clips
    # per-channel under strong gains while yuv clips luma, so a
    # pipeline mismatch would masquerade as an injection bug
    inject = np.array([1.15, 0.85], dtype=np.float32)
    single = Mapper(
        mt, sizes, blend=32, enable_gain=True, pipeline="yuv420"
    )
    ref_inj, g_ref = single.stitch(frames, gains=inject)

    sm = ShardedMapper(
        mt, sizes, mesh, blend=32, enable_gain=True, pipeline="yuv420"
    )
    batch = [np.stack([f, f]) for f in frames]
    out_solve, g_solve = sm.stitch_batch(batch)
    out_inj, g_inj = sm.stitch_batch(
        batch, gains=np.stack([inject, inject])
    )
    # the injected gains are returned verbatim and differ from solve
    np.testing.assert_allclose(np.asarray(g_inj), np.stack([inject] * 2))
    assert np.abs(np.asarray(g_solve)[0] - inject).max() > 0.05

    yuv = sm.assemble_yuv(np.asarray(out_inj)[0])
    err = np.abs(
        yuv.astype(np.float32) - np.asarray(ref_inj).astype(np.float32)
    )
    oh = mt.out_size[1]
    assert err[:oh].mean() < 0.1, err[:oh].mean()
    # and the injection visibly changed the output vs self-solve
    yuv_s = sm.assemble_yuv(np.asarray(out_solve)[0])
    assert (
        np.abs(yuv.astype(np.float32) - yuv_s.astype(np.float32)).mean()
        > 0.5
    )


def test_pipeline_sharded_gain_copy_matches_single_chip(setup):
    """Stereo-role dual output, gain_modes=[0, 0]: output 1 copies
    output 0's per-frame gains.  The sharded pipeline must match the
    single-chip AsyncMultiMapper frame for frame, and the copier's
    frames must equal the solver's (same template, shared gains)."""
    mt, sizes, frames = setup
    mesh = make_mesh(2, 4)
    n_frames = 4
    feeds = []
    for t in range(n_frames):
        # drifting exposure so gains vary per frame
        f = render_camera_frames(
            rig_cached(), exposure_gains=[1.25 + 0.05 * t, 0.8]
        )
        feeds.append(f)

    def run(mappers):
        amm = AsyncMultiMapper(mappers, gain_modes=[0, 0], donate=False)
        outs = []
        try:
            for f in feeds:
                amm.push(f)
            amm.close_input()
            for _ in range(n_frames):
                outs.append(amm.pop())
        finally:
            amm.close()
        return outs

    single_outs = run(
        [
            Mapper(
                mt, sizes, blend=32, enable_gain=True, pipeline="yuv420"
            )
            for _ in range(2)
        ]
    )
    sharded_outs = run(
        [
            ShardedMapper(
                mt, sizes, mesh, blend=32, enable_gain=True,
                pipeline="yuv420",
            )
            for _ in range(2)
        ]
    )

    oh = mt.out_size[1]
    for t in range(n_frames):
        for k in range(2):
            a = single_outs[t][k].astype(np.float32)
            b = sharded_outs[t][k].astype(np.float32)
            err = np.abs(a - b)[:oh]
            assert err.mean() < 0.15, (t, k, err.mean())
        # copier == solver output (identical template + shared gains)
        d01 = np.abs(
            sharded_outs[t][0].astype(np.float32)
            - sharded_outs[t][1].astype(np.float32)
        )
        assert d01.max() <= 1.0, (t, d01.max())


_RIG = None


def rig_cached():
    global _RIG
    if _RIG is None:
        _RIG = two_fisheye_rig()
        for spec in _RIG["inputs"]:
            spec["options"].update(width=256, height=256)
    return _RIG
