#!/usr/bin/env python
"""Multi-host (multi-process) sharded stitch — executes the
runtime/distributed.py path for real.

The reference is single-host; its process boundary is the GUI
orchestrating dumper/FFmpeg workers (apps/livestitching/runner.cpp:58-90).
The multi-host design here instead runs one JAX process per host under
`jax.distributed`, with frames fanned out on the 'data' mesh axis (each
process feeds its own locally-captured frames — no frame bytes cross
hosts) and the canvas optionally space-sharded within each host's
devices.  This tool validates that design end-to-end on N local
processes over the CPU backend (coordinator on 127.0.0.1), the same
code path a multi-host cluster would run.  It stays on the CPU: its
several processes would each reserve most of a card's memory.

    init_distributed -> make_global_mesh -> ShardedMapper
    -> global_frame_batch -> stitch_batch -> local_output_shards

Launcher mode (default) spawns N workers of this same file, collects
their PARITY/RESULT lines, and prints one summary JSON.  Run directly:

    python tools/multihost_stitch.py --procs 2 --devices-per-proc 4
"""

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

PI = math.pi


def rig(cam):
    lens = {
        "width": cam,
        "height": cam,
        "hfov": PI * 1.15,
        "center_dx": 0.0,
        "center_dy": 0.0,
        "radial": [0.0, 0.0, 0.0],
        "vignette": [1.0, -0.1, 0.0, 0.0],
    }
    return {
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


def local_frames(r, proc_id, batch_per_proc, step=0):
    """Each process 'captures' its own frames locally (distinct content
    per process and per step, so nothing is memoized)."""
    rng = np.random.default_rng(1000 * (proc_id + 1) + step)
    sets = []
    for _ in range(batch_per_proc):
        fs = []
        for spec in r["inputs"]:
            w = spec["options"]["width"]
            h = spec["options"]["height"]
            fs.append(rng.integers(0, 255, (h * 3 // 2, w), dtype=np.uint8))
        sets.append(np.stack(fs))
    return np.stack(sets)


def assemble_from_local_shards(sm, shards, batch_index):
    """Rebuild one frame's [S*bh*3/2, Wp] band stack from this process's
    addressable output shards (mesh row = this host's devices)."""
    rows = []
    for index, arr in shards:
        b = index[0].start if index[0].start is not None else 0
        if b == batch_index:
            r0 = index[1].start if index[1].start is not None else 0
            rows.append((r0, arr[0]))
    rows.sort(key=lambda t: t[0])
    return np.concatenate([a for _, a in rows], axis=0)


def run_worker(args):
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={args.devices_per_proc}"
    )
    import jax

    # several worker processes: keep every one of them on the CPU
    # backend (JAX_PLATFORMS=cpu), never on a shared card
    jax.config.update("jax_platforms", "cpu")

    from octvr_tpu.runtime.distributed import (
        global_frame_batch,
        init_distributed,
        local_output_shards,
        make_global_mesh,
    )

    if args.procs > 1:
        init_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.procs,
            process_id=args.proc_id,
        )
        assert jax.process_count() == args.procs

    from octvr_tpu.parallel.sharded import ShardedMapper
    from octvr_tpu.stitch import Mapper
    from octvr_tpu.template import compile_rig

    W, H = (int(v) for v in args.canvas.split("x"))
    r = rig(args.cam)
    mt = compile_rig(r, W, H)
    mt.create_masks()
    sizes = [(args.cam, args.cam)] * len(r["inputs"])

    mesh = make_global_mesh(n_data=args.procs, n_space=args.devices_per_proc)
    sm = ShardedMapper(
        mt, sizes, mesh, blend=args.blend, enable_gain=True,
        pipeline=args.pipeline,
    )

    def log(msg):
        print(f"[proc {args.proc_id}] {msg}", file=sys.stderr, flush=True)

    # ---- one step + parity vs the single-device Mapper on OUR frames
    mine = local_frames(r, args.proc_id, 1)
    batch = global_frame_batch(mine, mesh)
    out, gains = sm.stitch_batch(batch)
    shards = local_output_shards(out)
    # this process owns exactly its own data row (its frames never left);
    # single-process shards carry slice(None) over the batch axis
    assert all(
        (idx[0].start or 0) == args.proc_id for idx, _ in shards
    ), [idx for idx, _ in shards]
    yuv = sm.assemble_yuv(
        assemble_from_local_shards(sm, shards, args.proc_id)
    )

    single = Mapper(
        mt, sizes, blend=args.blend, enable_gain=True,
        pipeline=args.pipeline,
    )
    ref, ref_gains = single.stitch(list(mine[0]))
    ref = np.asarray(ref)
    err = np.abs(yuv.astype(np.float32) - ref.astype(np.float32))
    h = ref.shape[0] * 2 // 3
    y_mean = float(err[4:h - 4].mean())
    g_shard = next(
        s for s in gains.addressable_shards
        if (s.index[0].start or 0) == args.proc_id
    )
    my_gains = np.asarray(g_shard.data)[0]
    g_err = float(np.abs(my_gains - np.asarray(ref_gains)).max())
    ok = y_mean < 1.5 and g_err < 0.05
    print(
        "PARITY "
        + json.dumps(
            {
                "proc": args.proc_id,
                "y_mean_err": round(y_mean, 4),
                "gain_err": round(g_err, 5),
                "ok": bool(ok),
            }
        ),
        flush=True,
    )

    # ---- timed steps (distinct frames per step; value-sync via local
    # shard readback, global barrier around the window)
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("bench_start")
    t0 = time.time()
    for it in range(args.iters):
        mine = local_frames(r, args.proc_id, 1, step=1 + it)
        batch = global_frame_batch(mine, mesh)
        out, _ = sm.stitch_batch(batch)
        _ = [np.asarray(a).sum() for _, a in local_output_shards(out)]
    multihost_utils.sync_global_devices("bench_end")
    dt = (time.time() - t0) / args.iters
    fps = args.procs / dt  # one frame per process per step
    log(f"{dt * 1e3:.1f} ms/step, {fps:.2f} frames/s global")
    if args.proc_id == 0:
        print(
            "RESULT "
            + json.dumps(
                {
                    "procs": args.procs,
                    "devices_per_proc": args.devices_per_proc,
                    "mesh": [args.procs, args.devices_per_proc],
                    "pipeline": args.pipeline,
                    "ms_per_step": round(dt * 1e3, 1),
                    "frames_per_s": round(fps, 3),
                }
            ),
            flush=True,
        )


def run_launcher(args):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def spawn(procs):
        workers = []
        for i in range(procs):
            cmd = [
                sys.executable, os.path.abspath(__file__),
                "--proc-id", str(i),
                "--coordinator", f"127.0.0.1:{port}",
                "--procs", str(procs),
                "--devices-per-proc", str(args.devices_per_proc),
                "--cam", str(args.cam),
                "--canvas", args.canvas,
                "--blend", str(args.blend),
                "--iters", str(args.iters),
                "--pipeline", args.pipeline,
            ]
            workers.append(
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True,
                )
            )
        outs = []
        for i, w in enumerate(workers):
            out, errtxt = w.communicate(timeout=args.timeout)
            if w.returncode != 0:
                print(errtxt[-4000:], file=sys.stderr)
                raise SystemExit(
                    f"worker {i}/{procs} failed rc={w.returncode}"
                )
            for line in errtxt.splitlines():
                if line.startswith("[proc"):
                    print(line, file=sys.stderr)
            outs.append(out)
        return outs

    outs = spawn(args.procs)
    parity, result = [], None
    for out in outs:
        for line in out.splitlines():
            if line.startswith("PARITY "):
                parity.append(json.loads(line[len("PARITY "):]))
            elif line.startswith("RESULT "):
                result = json.loads(line[len("RESULT "):])
    assert result is not None and len(parity) == args.procs
    summary = {
        "metric": "multihost_stitch",
        "parity_ok": all(p["ok"] for p in parity),
        "parity": parity,
        **result,
    }
    if args.baseline:
        # single-process run, same per-process device count: weak-scaling
        # reference point.  NOTE on this 2-core host the N-process number
        # is core-bound, not design-bound — record both, judge with the
        # hardware in mind.
        outs1 = run_single(args, port + 1)
        for line in outs1.splitlines():
            if line.startswith("RESULT "):
                base = json.loads(line[len("RESULT "):])
                summary["single_proc_frames_per_s"] = base["frames_per_s"]
                summary["weak_scaling_efficiency"] = round(
                    result["frames_per_s"]
                    / (args.procs * base["frames_per_s"]),
                    3,
                )
    print(json.dumps(summary))


def run_single(args, port):
    cmd = [
        sys.executable, os.path.abspath(__file__),
        "--proc-id", "0",
        "--coordinator", f"127.0.0.1:{port}",
        "--procs", "1",
        "--devices-per-proc", str(args.devices_per_proc),
        "--cam", str(args.cam),
        "--canvas", args.canvas,
        "--blend", str(args.blend),
        "--iters", str(args.iters),
        "--pipeline", args.pipeline,
    ]
    p = subprocess.run(
        cmd, capture_output=True, text=True, timeout=args.timeout
    )
    if p.returncode != 0:
        print(p.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"single-proc baseline failed rc={p.returncode}")
    return p.stdout


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--cam", type=int, default=192)
    ap.add_argument("--canvas", default="384x192")
    ap.add_argument("--blend", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--pipeline", default="yuv420",
                    choices=["rgb", "yuv420"])
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--baseline", action="store_true",
                    help="also run a 1-process reference and report "
                    "weak-scaling efficiency")
    # worker-only
    ap.add_argument("--proc-id", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    args = ap.parse_args()

    if args.proc_id is not None:
        run_worker(args)
    else:
        run_launcher(args)


if __name__ == "__main__":
    main()
