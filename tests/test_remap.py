"""The packed remap gather (ops/remap.py), the one remap every pipeline
uses, against a float64 NumPy gather of the same plan."""

import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from octvr_tpu.ops.remap import (
    pack_planes,
    remap_apply_packed,
    remap_plan,
    stack_remap_plans,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import TOL_BF16, TOL_F32  # noqa: E402

TOL = {"float32": TOL_F32, "bfloat16": TOL_BF16}


def _maps(rh, rw, seed, invalid_frac=0.1):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(
        np.linspace(0.02, 0.98, rh), np.linspace(0.02, 0.98, rw), indexing="ij"
    )
    m1 = (xx + 0.02 * np.sin(7 * yy)).astype(np.float32)
    m2 = (yy + 0.02 * np.cos(5 * xx)).astype(np.float32)
    bad = rng.uniform(size=(rh, rw)) < invalid_frac
    m1[bad] = -1.0
    m2[bad] = -1.0
    return m1, m2


def _ref(planes, plan):
    """float64 bilinear gather of the plan's taps."""
    flat = planes.reshape(planes.shape[0], -1).astype(np.float64)
    out = np.zeros((planes.shape[0], plan.idx.shape[-1]))
    for k in range(4):
        out += flat[:, plan.idx[k]] * plan.w[k].astype(np.float64)
    return out.reshape(planes.shape[0], *plan.out_shape)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nc", [1, 2, 3])
def test_packed_gather_matches_float64(nc, out_dtype):
    """nc=1 (luma), nc=2 (U|V at half resolution), nc=3 (packed RGB),
    in both output dtypes."""
    in_h, in_w = 37, 53
    m1, m2 = _maps(29, 41, seed=nc)
    plan = remap_plan(m1, m2, in_h, in_w)
    planes = np.random.default_rng(10 + nc).integers(0, 256, (nc, in_h, in_w))
    packed = pack_planes([jnp.asarray(p, jnp.float32) for p in planes])
    assert packed.dtype == jnp.int32
    out = remap_apply_packed(packed, plan, nc=nc, out_dtype=out_dtype)
    assert out.shape == (nc, 29, 41) and out.dtype == jnp.dtype(out_dtype)
    err = np.abs(np.asarray(out, np.float64) - _ref(planes, plan)).max()
    assert err <= TOL[out_dtype], err


def test_invalid_map_fills_zero():
    """Negative map entries (fast_remap.cu fill_zero) give exact 0."""
    m1, m2 = _maps(16, 24, seed=4, invalid_frac=0.3)
    plan = remap_plan(m1, m2, 20, 30)
    planes = np.full((3, 20, 30), 200.0, np.float32)
    out = np.asarray(
        remap_apply_packed(pack_planes(list(jnp.asarray(planes))), plan)
    )
    bad = m1 < 0
    assert bad.any() and (~bad).any()
    assert np.all(out[:, bad] == 0.0)
    np.testing.assert_allclose(out[:, ~bad], 200.0, atol=1e-3)


def test_edge_clamp():
    """Samples past the border clamp to the edge pixel (texture clamp
    mode): a map half a pixel outside reads the edge value exactly."""
    in_h, in_w = 6, 8
    img = np.arange(in_h * in_w, dtype=np.float32).reshape(1, in_h, in_w)
    # pixel centres x = -0.5 and x = W - 0.5 + 1 (both outside)
    m1 = np.array([[0.0, 1.0, 1.0 + 0.5 / in_w]], np.float32)
    m2 = np.full_like(m1, 0.5 / in_h)
    plan = remap_plan(m1, m2, in_h, in_w)
    out = np.asarray(remap_apply_packed(pack_planes([jnp.asarray(img[0])]), plan, nc=1))
    np.testing.assert_allclose(out[0, 0], [0.0, in_w - 1, in_w - 1], atol=1e-4)
    assert np.all(plan.idx >= 0) and np.all(plan.idx < in_h * in_w)


def test_packing_round_trips_channels():
    """pack_planes rounds, clips to [0, 255] and keeps channel c in byte c."""
    planes = [jnp.asarray([[-3.0, 12.4]]), jnp.asarray([[255.6, 7.5]])]
    packed = np.asarray(pack_planes(planes))
    np.testing.assert_array_equal(packed & 0xFF, [[0, 12]])
    np.testing.assert_array_equal((packed >> 8) & 0xFF, [[255, 8]])


def test_stacked_shard_plans_pad_with_zero_weight():
    """Per-shard plans over window maps of one shape stack on a leading
    axis; pixels a shard's window does not cover (map -1, the padding)
    have weight 0, and each stacked slice applies as its own plan."""
    in_h, in_w = 24, 32
    m1, m2 = _maps(12, 20, seed=7, invalid_frac=0.0)
    shards = []
    for s in range(3):
        a1, a2 = m1.copy(), m2.copy()
        a1[: 4 * s] = -1.0  # shard s's window starts 4*s rows lower
        a2[: 4 * s] = -1.0
        shards.append(remap_plan(a1, a2, in_h, in_w))
    stacked = stack_remap_plans(shards)
    assert stacked.idx.shape == (3, 4, 12 * 20)
    assert stacked.w.shape == (3, 4, 12 * 20)
    planes = np.random.default_rng(3).integers(0, 256, (2, in_h, in_w))
    packed = pack_planes([jnp.asarray(p, jnp.float32) for p in planes])
    for s, plan in enumerate(shards):
        one = type(plan)(
            idx=stacked.idx[s], w=stacked.w[s],
            out_shape=stacked.out_shape, in_shape=stacked.in_shape,
        )
        out = np.asarray(remap_apply_packed(packed, one, nc=2))
        assert np.all(stacked.w[s][:, : 4 * s * 20] == 0.0)
        assert np.all(out[:, : 4 * s] == 0.0)
        np.testing.assert_allclose(out, _ref(planes, plan), atol=TOL["float32"])
    with pytest.raises(ValueError):
        stack_remap_plans([shards[0], remap_plan(m1[:6], m2[:6], in_h, in_w)])
