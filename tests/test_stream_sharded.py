"""BASELINE config 5 composition (VERDICT r3 next #3): file-sourced
frames stream through the AsyncMultiMapper pipeline into a
ShardedMapper on a (data, space) mesh — the async.cpp:32-172 frame
pipeline driving the mesh-sharded engine — and the output stream
matches the single-chip streaming path frame for frame."""

import math

import numpy as np
import pytest

import jax.numpy as jnp

PI = math.pi


@pytest.fixture(scope="module")
def stream_setup(tmp_path_factory):
    from octvr_tpu.ops.color import rgb_planar_to_yuv420p
    from octvr_tpu.template import compile_rig
    from octvr_tpu.template.io import save_npz

    lens = {
        "width": 128,
        "height": 128,
        "hfov": PI * 1.15,
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
                    "rotation": {"roll": 0.0, "yaw": PI, "pitch": 0.0},
                },
            },
        ],
    }
    mt = compile_rig(rig, 128, 64)
    mt.create_masks()
    d = tmp_path_factory.mktemp("stream_sharded")
    tmpl = d / "tmpl.npz"
    save_npz(mt, str(tmpl))

    # 6 frames x 2 cameras of a drifting gradient scene
    rng = np.random.default_rng(3)
    n_frames = 6
    feeds = []
    for cam in range(2):
        p = d / f"cam{cam}.yuv"
        with open(p, "wb") as f:
            for t in range(n_frames):
                yy, xx = np.meshgrid(
                    np.linspace(0, 1, 128), np.linspace(0, 1, 128),
                    indexing="ij",
                )
                base = 120 + 60 * np.sin(
                    2 * PI * (xx + 0.1 * t + 0.3 * cam)
                ) * np.cos(2 * PI * yy)
                rgb = np.stack(
                    [base, base * 0.9 + 10, base * 1.1 - 10]
                ).clip(0, 255)
                yuv = np.asarray(
                    rgb_planar_to_yuv420p(jnp.asarray(rgb.astype(np.float32)))
                )
                f.write(yuv.tobytes())
        feeds.append(str(p))
    return str(tmpl), feeds, n_frames, d


def _run_stream(tmpl, feeds, out_path, extra):
    from octvr_tpu.cli.stream import main

    main(
        [
            "--inputs", ",".join(feeds),
            "--in_size", "128x128",
            "--outputs", f"{tmpl}:8:0",
            "--out", str(out_path),
        ]
        + extra
    )


def test_stream_through_sharded_mapper(stream_setup):
    import jax

    assert len(jax.devices()) >= 8
    tmpl, feeds, n_frames, d = stream_setup

    out_single = d / "single.yuv"
    out_sharded = d / "sharded.yuv"
    _run_stream(tmpl, feeds, out_single, ["--pipeline", "yuv420"])
    _run_stream(
        tmpl, feeds, out_sharded,
        ["--pipeline", "yuv420", "--sharded", "2x4"],
    )

    a = np.fromfile(out_single, dtype=np.uint8)
    b = np.fromfile(out_sharded, dtype=np.uint8)
    frame_bytes = 64 * 3 // 2 * 128
    assert len(a) == n_frames * frame_bytes
    assert len(b) == n_frames * frame_bytes
    err = np.abs(a.astype(np.float32) - b.astype(np.float32))
    assert err.mean() < 0.5, err.mean()

    # frame ORDER must survive the data-batched dispatch: frames drift
    # over time, so a misordered stream shows up as a large per-frame
    # diff against the single-chip stream
    av = a.reshape(n_frames, -1).astype(np.float32)
    bv = b.reshape(n_frames, -1).astype(np.float32)
    per_frame = np.abs(av - bv).mean(axis=1)
    assert per_frame.max() < 1.0, per_frame


def test_stream_synthetic_source(stream_setup, tmp_path):
    """--source synthetic: device-resident rotating frame sets through
    the same pipeline code (the de-extrapolated device-bound fps mode,
    VERDICT r3 next #4)."""
    from octvr_tpu.cli.stream import main

    tmpl, feeds, n_frames, d = stream_setup
    out = tmp_path / "syn.yuv"
    main(
        [
            "--in_size", "128x128",
            "--outputs", f"{tmpl}:8:0",
            "--out", str(out),
            "--source", "synthetic",
            "--frames", "5",
            "--pipeline", "yuv420",
        ]
    )
    frame_bytes = 64 * 3 // 2 * 128
    data = np.fromfile(out, dtype=np.uint8)
    assert len(data) == 5 * frame_bytes
    assert data[:frame_bytes].std() > 1.0


def test_stream_sharded_gain_copy_mode(stream_setup, tmp_path):
    """Copy gain modes (output 1 reuses output 0's gains,
    async.hpp:79 encoding 'tmpl:blend:0' on output index 1) are now
    HONORED on the sharded path (VERDICT r4 next #3 killed the silent
    self-solve rewrite): the two outputs share one template, so the
    copier's stream must equal the solver's."""
    from octvr_tpu.cli.stream import main

    tmpl, feeds, n_frames, d = stream_setup
    out0 = tmp_path / "o0.yuv"
    out1 = tmp_path / "o1.yuv"
    main(
        [
            "--inputs", ",".join(feeds),
            "--in_size", "128x128",
            # output 0 solves (gain_mode 0 == own index); output 1
            # copies output 0's gains (gain_mode 0 != own index 1)
            "--outputs", f"{tmpl}:8:0,{tmpl}:8:0",
            "--out", f"{out0},{out1}",
            "--pipeline", "yuv420",
            "--sharded", "2x4",
        ]
    )
    a = np.fromfile(out0, dtype=np.uint8)
    b = np.fromfile(out1, dtype=np.uint8)
    frame_bytes = 64 * 3 // 2 * 128
    assert len(a) == n_frames * frame_bytes
    np.testing.assert_array_equal(a, b)
