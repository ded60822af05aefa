"""Data-axis frame batching through the sharded engine: when a
device's 'data' shard carries more than one frame set, the band
stitch runs them all in one program — output and gains must match the
per-frame path."""

import numpy as np

import jax

from octvr_tpu.parallel.sharded import ShardedMapper, make_mesh
from octvr_tpu.stitch import Mapper
from octvr_tpu.template import compile_rig
from rigs import two_fisheye_rig
from test_stitch import render_camera_frames


def test_sharded_data_batch_matches_single_chip():
    rig = two_fisheye_rig()
    for spec in rig["inputs"]:
        spec["options"].update(width=256, height=256)
    mt = compile_rig(rig, 256, 128)
    mt.create_masks()
    sizes = [(256, 256)] * 2
    f0 = render_camera_frames(rig, exposure_gains=[1.2, 0.85])
    f1 = render_camera_frames(rig, exposure_gains=[0.9, 1.1])
    single = Mapper(mt, sizes, blend=32, enable_gain=True,
                    pipeline="yuv420")
    o0, g0 = single.stitch(f0)
    o1, g1 = single.stitch(f1)

    # mesh data=2, space=2 with B=4 -> per-device local batch of 2
    mesh = make_mesh(2, 2)
    sm = ShardedMapper(
        mt, sizes, mesh, blend=32, enable_gain=True, pipeline="yuv420"
    )
    order = [f0, f1, f1, f0]
    refs = [(o0, g0), (o1, g1), (o1, g1), (o0, g0)]
    batch = [
        np.stack([order[b][i] for b in range(4)]) for i in range(2)
    ]
    out, g = sm.stitch_batch(batch)
    for b, (ref, gref) in enumerate(refs):
        np.testing.assert_allclose(
            np.asarray(g)[b], np.asarray(gref), rtol=2e-3
        )
        yuv = sm.assemble_yuv(np.asarray(out)[b])
        err = np.abs(
            yuv.astype(np.float32) - np.asarray(ref).astype(np.float32)
        )
        # frame ORDER matters: f0 vs f1 differ by their exposure
        # offsets, so a b-axis mixup fails loudly here
        assert err[:128].mean() < 0.1, (b, err[:128].mean())
