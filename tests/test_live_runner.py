"""Live session runner: validation, dump->stream supervision
(runner.cpp:40-95 role)."""

import json
import os
import subprocess
import sys

import numpy as np

from octvr_tpu.cli.live import validate_rig
from rigs import two_fisheye_rig
from test_stitch import render_camera_frames

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_validate_rig():
    rig = two_fisheye_rig()
    assert validate_rig(rig, 2, (1200, 1200)) == []
    assert validate_rig(rig, 3, (1200, 1200))  # count mismatch
    assert validate_rig(rig, 2, (640, 480))  # size mismatch


def test_live_session_end_to_end(tmp_path):
    rig = two_fisheye_rig()
    for spec in rig["inputs"]:
        spec["options"]["width"] = 256
        spec["options"]["height"] = 256
    rig_path = tmp_path / "rig.json"
    rig_path.write_text(json.dumps(rig))

    frames = render_camera_frames(rig)
    for i, f in enumerate(frames):
        with open(tmp_path / f"in{i}.yuv", "wb") as fh:
            for _ in range(4):
                fh.write(np.asarray(f).tobytes())

    out = tmp_path / "pano.yuv"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [
            sys.executable,
            "-m",
            "octvr_tpu.cli.live",
            "--rig",
            str(rig_path),
            "--inputs",
            f"{tmp_path}/in0.yuv,{tmp_path}/in1.yuv",
            "--in_size",
            "256x256",
            "--out_size",
            "256x128",
            "--out",
            str(out),
            "--blend",
            "8",
            "--workdir",
            str(tmp_path / "work"),
        ],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=500,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert out.stat().st_size == 4 * (128 * 3 // 2) * 256
    assert "stream finished cleanly" in res.stderr
