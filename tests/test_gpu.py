"""Full-width checks that need the card: the remap gather at the 4K
six-camera shapes against a float64 gather, and the 4K Mapper with
library defaults against the analytic world.  Run them on a GPU with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu

Elsewhere they skip with a reason (chip_smoke.py runs the same checks
and more)."""

import os
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the tolerances)


@pytest.fixture(scope="module")
def rig_4k():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU at full width; JAX found {dev.platform}")
    import bench
    from octvr_tpu.stitch import Mapper
    from octvr_tpu.template import compile_rig

    rig = bench.six_cam_rig()
    mt = compile_rig(rig, bench.CANVAS_W, bench.CANVAS_H)
    mt.create_masks()
    sizes = [(bench.CAM, bench.CAM)] * 6
    mapper = Mapper(mt, sizes, blend=bench.BLEND, enable_gain=True)
    return rig, mapper


@pytest.mark.parametrize("plane", ["Y", "UV"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_remap_4k_matches_float64(rig_4k, plane, out_dtype):
    import jax.numpy as jnp

    from octvr_tpu.ops.remap import pack_planes, remap_apply_packed

    _, mapper = rig_4k
    nc = 1 if plane == "Y" else 2
    tol = chip_smoke.TOL_F32 if out_dtype == "float32" else chip_smoke.TOL_BF16
    rng = np.random.default_rng(0)
    for ip in mapper.plan.inputs:
        plan = ip.remap if plane == "Y" else ip.remap_uv
        side = plan.in_shape[0]
        planes = rng.integers(0, 256, (nc, side, side))
        packed = pack_planes([jnp.asarray(p, jnp.float32) for p in planes])
        ref = np.zeros((nc, plan.idx.shape[1]))
        for k in range(4):
            ref += planes.reshape(nc, -1)[:, plan.idx[k]] * plan.w[k].astype(np.float64)
        out = remap_apply_packed(packed, plan, nc=nc, out_dtype=out_dtype)
        err = np.abs(np.asarray(out, np.float64).reshape(nc, -1) - ref).max()
        assert err <= tol, err


def test_mapper_4k_defaults_match_world(rig_4k):
    from rigs import ground_truth, render_camera_frames, rgb_from_yuv_buf

    rig, mapper = rig_4k
    out, gains = mapper.stitch(render_camera_frames(rig))
    got = rgb_from_yuv_buf(np.asarray(out))
    h, w = got.shape[:2]
    truth = ground_truth(w, h)
    pole = h // 32
    err = np.abs(got[pole:-pole] - truth[pole:-pole]).mean()
    assert err <= chip_smoke.TOL_WORLD, err
    np.testing.assert_allclose(np.asarray(gains), 1.0, atol=chip_smoke.TOL_GAIN_UNITY)
