"""Multi-process (multi-host analog) sharded stitch: the
runtime/distributed.py path executed for real.

Spawns a 2-process `jax.distributed` group on localhost (CPU backend,
2 forced devices each — the same SPMD code path a multi-host cluster runs),
drives ShardedMapper through init_distributed / make_global_mesh /
global_frame_batch / local_output_shards, and checks each process's
assembled output against a single-device Mapper on its own frames.

Reference analog: the process boundary the OwlLive GUI orchestrates
(apps/livestitching/runner.cpp:58-90) — here the processes share one
SPMD program instead of a dumper/FFmpeg pipeline.
"""

import json
import os
import subprocess
import sys
import pytest

pytestmark = pytest.mark.slow

TOOL = os.path.join(
    os.path.dirname(__file__), "..", "tools", "multihost_stitch.py"
)


@pytest.mark.parametrize("blend", [8, 32])
def test_two_process_distributed_stitch(blend):
    """blend=8: single-level band blend (no image bytes cross chips).
    blend=32: the two-level split is active, so the level-L Gaussian
    all-gather is a REAL cross-process collective over the 'space'
    axis — the sharded design's only image-byte exchange, exercised
    across an actual process boundary."""
    p = subprocess.run(
        [
            sys.executable,
            TOOL,
            "--procs", "2",
            "--devices-per-proc", "2",
            "--cam", "96",
            "--canvas", "192x96",
            "--blend", str(blend),
            "--iters", "1",
            "--pipeline", "yuv420",
        ],
        capture_output=True,
        text=True,
        timeout=850,
    )
    assert p.returncode == 0, p.stderr[-4000:]
    summary = json.loads(p.stdout.strip().splitlines()[-1])
    assert summary["procs"] == 2
    assert summary["parity_ok"], summary
    assert len(summary["parity"]) == 2
    for par in summary["parity"]:
        assert par["y_mean_err"] < 1.5
        assert par["gain_err"] < 0.05
    assert summary["frames_per_s"] > 0
