#!/usr/bin/env python
"""Benchmark: stitched 4K frames/sec/chip on a 6-camera rig
(BASELINE.json primary metric).

Pipeline measured: YUV420P x6 (1920x1920 cams) -> vignette -> remap ->
exposure-gain solve+apply -> 6-band multiband Laplacian blend -> 4K
(3840x1920) equirect YUV420P out, with the library defaults.
Steady-state, device-resident inputs (distinct buffers per iteration),
timed with block_until_ready.  Needs an accelerator: on the CPU it
fails instead of printing a number.

The reference publishes no numbers (BASELINE.md); vs_baseline is
measured against its implied real-time target of 30 fps live stitching
(apps/livestitching defaults, async.cpp FPS meter).
"""

import json
import math
import sys
import time

import numpy as np

PI = math.pi

CANVAS_W, CANVAS_H = 3840, 1920
CAM = 1920
BLEND = 128
ITERS = 24
BASELINE_FPS = 30.0


def six_cam_rig():
    inputs = []
    for yaw in (0, PI / 2, PI, -PI / 2):
        inputs.append(
            {
                "type": "fullframe_fisheye",
                "options": {
                    "width": CAM,
                    "height": CAM,
                    "hfov": 1.75,
                    "center_dx": 0.0,
                    "center_dy": 0.0,
                    "radial": [0.01, -0.02, 0.0],
                    "vignette": [1.0, -0.15, 0.05, 0.0],
                    "rotation": {"roll": 0.0, "yaw": yaw, "pitch": 0.0},
                },
            }
        )
    for pitch in (PI / 2, -PI / 2):
        inputs.append(
            {
                "type": "fullframe_fisheye",
                "options": {
                    "width": CAM,
                    "height": CAM,
                    "hfov": 2.2,
                    "center_dx": 0.0,
                    "center_dy": 0.0,
                    "radial": [0.01, -0.02, 0.0],
                    "vignette": [1.0, -0.15, 0.05, 0.0],
                    "rotation": {"roll": 0.0, "yaw": 0.0, "pitch": pitch},
                },
            }
        )
    return {
        "output": {"type": "equirectangular", "options": {}},
        "inputs": inputs,
    }


def parity_smoke():
    """The packed remap gather on the device against a float64 NumPy
    gather of the same plan (nc = 1, 2, 3; float32 and bfloat16 out): a
    wrong gather fails HERE, loudly, before the 4K run."""
    import jax.numpy as jnp

    from chip_smoke import TOL_BF16, TOL_F32
    from octvr_tpu.ops.remap import pack_planes, remap_apply_packed, remap_plan

    rng = np.random.default_rng(7)
    in_h, in_w = 96, 256
    yy, xx = np.meshgrid(
        np.linspace(0, 1, 64), np.linspace(0, 1, 256), indexing="ij"
    )
    m1 = (0.5 + 0.45 * np.cos(2 * np.pi * xx) * (0.3 + 0.6 * yy)).astype(
        np.float32
    )
    m2 = (0.5 + 0.45 * np.sin(2 * np.pi * xx) * (0.3 + 0.6 * yy)).astype(
        np.float32
    )
    m1[10:20, 30:60] = -1
    m2[10:20, 30:60] = -1
    plan = remap_plan(m1, m2, in_h, in_w)
    for nc in (1, 2, 3):
        planes = rng.integers(0, 256, (nc, in_h, in_w))
        packed = pack_planes([jnp.asarray(p, jnp.float32) for p in planes])
        ref = np.zeros((nc, plan.idx.shape[1]))
        for k in range(4):
            ref += planes.reshape(nc, -1)[:, plan.idx[k]] * plan.w[k].astype(
                np.float64
            )
        for dt, tol in (("float32", TOL_F32), ("bfloat16", TOL_BF16)):
            out = remap_apply_packed(packed, plan, nc=nc, out_dtype=dt)
            err = float(
                np.abs(np.asarray(out, np.float64).reshape(nc, -1) - ref).max()
            )
            if err > tol:
                raise AssertionError(
                    f"remap parity smoke failed: nc={nc} {dt} err {err} > {tol}"
                )
    print("# parity smoke: remap == float64 gather (nc 1/2/3, f32/bf16)",
          file=sys.stderr)


def default_path_regression():
    """On-device regression test of the LIBRARY DEFAULTS:
    pipeline="auto" -> yuv420 with the default blend dtype must match
    the rgb/float32 path on a small rig.  Runs before the 4K bench, so a
    regression in the default path fails loudly here."""
    import math as _m

    import jax

    from octvr_tpu.stitch import Mapper
    from octvr_tpu.stitch.mapper import DEFAULT_BLEND_DTYPE
    from octvr_tpu.template import compile_rig

    lens = {
        "width": 512,
        "height": 512,
        "hfov": _m.pi * 1.15,
        "center_dx": 0.0,
        "center_dy": 0.0,
        "radial": [0.0, 0.0, 0.0],
    }
    rig = {
        "output": {"type": "equirectangular", "options": {}},
        "inputs": [
            {"type": "fullframe_fisheye", "options": dict(lens)},
            {
                "type": "fullframe_fisheye",
                "options": {
                    **lens,
                    "rotation": {"roll": 0.0, "yaw": _m.pi, "pitch": 0.0},
                },
            },
        ],
    }
    mt = compile_rig(rig, 256, 128)
    mt.create_masks()
    sizes = [(512, 512)] * 2
    m_def = Mapper(mt, sizes, blend=16)  # library defaults
    assert m_def.plan.pipeline == "yuv420", m_def.plan.pipeline
    assert m_def.plan.blender.compute_dtype == DEFAULT_BLEND_DTYPE
    m_ref = Mapper(
        mt, sizes, blend=16, pipeline="rgb", blend_dtype="float32"
    )
    # the fixture must be IN-GAMUT YUV (derived from real RGB): random
    # YUV noise falls outside the RGB cube, where the rgb path's gamut
    # clip and the yuv420 path (which never leaves YUV) legitimately
    # diverge — that's a fixture artifact, not a pipeline regression
    rng = np.random.default_rng(3)
    frames = []
    for _ in range(2):
        yy, xx = np.mgrid[0:512, 0:512].astype(np.float32) / 512.0
        rgb = np.stack(
            [
                127 + 90 * np.sin(6.3 * xx + 2 * yy + rng.uniform(0, 6)),
                127 + 90 * np.cos(4.1 * yy - 3 * xx + rng.uniform(0, 6)),
                127 + 90 * np.sin(2.7 * (xx + yy) + rng.uniform(0, 6)),
            ],
            axis=-1,
        ) + rng.normal(0.0, 6.0, (512, 512, 3))
        r, g, b = (np.clip(rgb, 0, 255)[..., c] for c in range(3))
        y = 0.299 * r + 0.587 * g + 0.114 * b
        u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
        v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
        u2 = u.reshape(256, 2, 256, 2).mean(axis=(1, 3))
        v2 = v.reshape(256, 2, 256, 2).mean(axis=(1, 3))
        buf = np.concatenate(
            [y, np.concatenate([u2, v2], axis=1)], axis=0
        )
        frames.append(np.clip(np.round(buf), 0, 255).astype(np.uint8))
    out_d, g_d = m_def.stitch(frames)
    with jax.default_matmul_precision("highest"):
        out_r, g_r = m_ref.stitch(frames)
    h = 128
    y_err = np.abs(
        np.asarray(out_d)[:h].astype(np.float32)
        - np.asarray(out_r)[:h].astype(np.float32)
    )
    if y_err.mean() >= 1.5:
        raise AssertionError(
            f"default-path regression: Y mean err {y_err.mean():.3f}"
        )
    np.testing.assert_allclose(
        np.asarray(g_d), np.asarray(g_r), rtol=0.05, atol=0.01
    )
    print(
        f"# default-path regression: yuv420+{DEFAULT_BLEND_DTYPE} == rgb+f32 "
        f"(Y mean err {y_err.mean():.3f}/255)",
        file=sys.stderr,
    )


def main():
    import jax
    import jax.numpy as jnp

    from octvr_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    device = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    print(f"# device: {device}", file=sys.stderr)
    if dev.platform == "cpu":
        raise SystemExit("bench.py measures an accelerator; found only the CPU")
    enable_compile_cache()

    from octvr_tpu.stitch import Mapper
    from octvr_tpu.template import compile_rig

    parity_smoke()
    default_path_regression()

    t0 = time.time()
    rig = six_cam_rig()
    mt = compile_rig(rig, CANVAS_W, CANVAS_H)
    mt.create_masks()
    print(f"# template compiled in {time.time()-t0:.1f}s", file=sys.stderr)

    sizes = [(CAM, CAM)] * 6
    t0 = time.time()
    mapper = Mapper(mt, sizes, blend=BLEND, enable_gain=True)
    print(
        f"# plan built in {time.time()-t0:.1f}s "
        f"(pipeline={mapper.plan.pipeline}, "
        f"blend_dtype={mapper.plan.blender.compute_dtype})",
        file=sys.stderr,
    )

    rng = np.random.default_rng(0)
    base = [
        rng.integers(0, 255, (CAM * 3 // 2, CAM), dtype=np.uint8)
        for _ in range(6)
    ]
    frame_sets = []
    for i in range(ITERS):
        frame_sets.append(
            tuple(
                jax.device_put(
                    np.clip(f.astype(np.int16) + i, 0, 255).astype(np.uint8)
                )
                for f in base
            )
        )
    jax.block_until_ready(frame_sets)

    t0 = time.time()
    out, gains = mapper.stitch(frame_sets[0])
    jax.block_until_ready(out)
    print(f"# first call (compile+run) {time.time()-t0:.1f}s", file=sys.stderr)
    # parity checksum: deterministic inputs (seed 0) -> deterministic
    # output; a silently-wrong stitch changes this number
    checksum = int(jnp.sum(out[::101, ::103].astype(jnp.int32)))
    print(f"# output checksum (frame 0): {checksum}", file=sys.stderr)
    sys.stderr.flush()

    t0 = time.time()
    outs = [mapper.stitch(fs)[0] for fs in frame_sets]
    jax.block_until_ready(outs)
    dt = (time.time() - t0) / ITERS
    fps = 1.0 / dt
    print(f"# steady-state {dt*1e3:.1f} ms/frame", file=sys.stderr)

    print(
        json.dumps(
            {
                "metric": "stitched_4k_fps_per_chip_6cam",
                "value": round(fps, 3),
                "unit": "frames/s",
                "vs_baseline": round(fps / BASELINE_FPS, 3),
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
