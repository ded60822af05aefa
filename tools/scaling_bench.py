#!/usr/bin/env python
"""Scaling-efficiency harness (BASELINE target: >= 0.8 frames/s scaling
efficiency at N >= 2).

Measures the sharded stitch at mesh sizes 1/2/4/8 on the devices JAX
finds (cards; with JAX_PLATFORMS=cpu and
XLA_FLAGS=--xla_force_host_platform_device_count=8, virtual CPU devices
that check control flow but time nothing a user runs) and reports:

* data-axis weak scaling: mesh (N, 1), batch N -> frames/s; ideal is
  linear, efficiency = fps(N) / (N * fps(1))
* space-axis strong scaling: mesh (1, S), one frame -> ms/frame;
  efficiency = t(1) / (S * t(S))

Usage: python tools/scaling_bench.py [--canvas 1024x512] [--cam 512]
       [--iters 8] [--json out.json]
"""

import argparse
import json
import math
import os
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


def frames_for(r, batch, seed=0):
    rng = np.random.default_rng(seed)
    sets = []
    for b in range(batch):
        fs = []
        for spec in r["inputs"]:
            w = spec["options"]["width"]
            h = spec["options"]["height"]
            fs.append(rng.integers(0, 255, (h * 3 // 2, w), dtype=np.uint8))
        sets.append(np.stack(fs))
    return np.stack(sets)


def timed(fn, iters):
    out, _ = fn()  # warm
    jax.block_until_ready(out)
    t0 = time.time()
    outs = [fn()[0] for _ in range(iters)]
    jax.block_until_ready(outs)
    return (time.time() - t0) / iters


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--canvas", default="1024x512")
    ap.add_argument("--cam", type=int, default=512)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--blend", type=int, default=32)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    import jax

    from octvr_tpu.parallel.sharded import ShardedMapper, make_mesh
    from octvr_tpu.template import compile_rig

    W, H = (int(v) for v in args.canvas.split("x"))
    r = rig(args.cam)
    mt = compile_rig(r, W, H)
    mt.create_masks()
    sizes = [(args.cam, args.cam)] * 2

    ndev = len(jax.devices())
    platform = jax.devices()[0].platform
    meshes = [n for n in (1, 2, 4, 8) if n <= ndev]
    results = {"platform": platform, "n_devices": ndev, "canvas": args.canvas}

    print(f"# {ndev} {platform} devices", file=sys.stderr)

    # ---- data-axis weak scaling
    data = {}
    for n in meshes:
        mesh = make_mesh(n, 1)
        sm = ShardedMapper(mt, sizes, mesh, blend=args.blend)
        batch = frames_for(r, n)
        dt = timed(lambda: sm.stitch_batch(batch), args.iters)
        fps = n / dt
        data[n] = fps
        eff = fps / (n * data[1])
        print(
            f"data mesh ({n},1): {dt*1e3:.1f} ms/step, {fps:.2f} frames/s, "
            f"efficiency {eff:.2f}",
            file=sys.stderr,
        )
    results["data_weak_fps"] = data
    results["data_efficiency"] = {
        n: data[n] / (n * data[1]) for n in meshes
    }

    # ---- space-axis strong scaling
    space = {}
    for n in meshes:
        mesh = make_mesh(1, n)
        sm = ShardedMapper(mt, sizes, mesh, blend=args.blend)
        batch = frames_for(r, 1)
        dt = timed(lambda: sm.stitch_batch(batch), args.iters)
        space[n] = dt
        eff = space[1] / (n * dt)
        print(
            f"space mesh (1,{n}): {dt*1e3:.1f} ms/frame, "
            f"efficiency {eff:.2f}",
            file=sys.stderr,
        )
    results["space_ms"] = {n: space[n] * 1e3 for n in meshes}
    results["space_efficiency"] = {
        n: space[1] / (n * space[n]) for n in meshes
    }

    print(json.dumps(results))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
