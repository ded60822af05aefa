#!/usr/bin/env python
"""On-card smoke test of the stitcher: the quickest proof that the system
starts on the GPU and stitches correctly at full width.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # ShardedMapper on four cards only

It drives the main path through the entry points a user calls
(``Mapper``, ``FastMapper``, ``cli.stream``, ``register_images``,
``ShardedMapper``) at the benchmarked rig: 4K 3840x1920 equirect from
six 1920x1920 fullframe fisheyes, multiband-128 plus exposure gains,
YUV420P in and out (bench.py).  Frames are rendered from an analytic
world, so every output is checked against the repo's own references:
the world itself, the float64 NumPy gather, the rgb + float32 path, the
CPU backend, and the float64 bundle adjuster.

Each phase prints one line; a failed phase makes the run exit non-zero
and print no result.  Without a GPU it exits non-zero at once.  One
process drives the card(s).  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

W4K, H4K, CAM, BLEND = 3840, 1920, 1920, 128
SMALL = (1024, 512)  # canvas of the card-vs-CPU comparison
PHONE = (1920, 960)  # canvas of the two-camera phone-class rig
N_STREAM = 8  # frames through cli.stream

# tolerances (levels of 255 unless stated)
TOL_F32 = 1e-3  # float32 gather vs float64: rounding of four products
TOL_BF16 = 0.5 + TOL_F32  # half a bf16 ulp at 255 (8 significand bits)
# 4K stitch vs the analytic world, mean over RGB away from the poles:
# the committed two-fisheye stitch reads 0.56 (README), this six-camera
# rig 0.80 on an H100 (multiband-128 ringing where the overlaps are
# narrower than the blend support)
TOL_WORLD = 1.0
TOL_GAIN_UNITY = 0.05  # gains on an evenly exposed world
TOL_PIPE_Y = 1.5  # other pipeline/dtype vs defaults (bench.py bars)
TOL_PIPE_GAIN = 0.05  # rtol of gains, same comparison
# card vs CPU backend: the same program, so only bf16 rounding order may
# differ (read 0 on an H100); a flipped rounding moves a byte by 1-2
TOL_CPU_Y = 0.05  # mean |dY|
TOL_CPU_Y_MAX = 2  # max |dY|
TOL_SHARD_Y = 0.2  # ShardedMapper vs Mapper, mean |dY| (dryrun bars)
TOL_SHARD_GAIN = 1e-3
TOL_BA_RMS = 1e-3  # jitted LM vs float64 NumPy LM
TOL_ANGLE_DEG = 2.0  # registered neighbour rotations
TOL_FOCAL = 0.08


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()


def y_plane(buf, h):
    return np.asarray(buf)[:h].astype(np.float32)


class Smoke:
    def __init__(self):
        sys.path.insert(0, ROOT)
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import bench
        from octvr_tpu.template import compile_rig

        self.rig = bench.six_cam_rig()
        for spec in self.rig["inputs"]:
            spec["options"].update(width=CAM, height=CAM)
        self.sizes = [(CAM, CAM)] * len(self.rig["inputs"])
        self.mt = compile_rig(self.rig, W4K, H4K)
        self.mt.create_masks()
        self._frames = None
        self._mapper = None

    @property
    def frames(self):
        if self._frames is None:
            from rigs import render_camera_frames

            self._frames = render_camera_frames(self.rig)
        return self._frames

    @property
    def mapper(self):
        """The 4K Mapper with library defaults."""
        if self._mapper is None:
            from octvr_tpu.stitch import Mapper

            self._mapper = Mapper(self.mt, self.sizes, blend=BLEND, enable_gain=True)
        return self._mapper

    # ----------------------------------------------------------- phases

    def build(self):
        r = subprocess.run(
            ["make", "-C", os.path.join(ROOT, "native")],
            capture_output=True,
            text=True,
        )
        if r.returncode != 0:
            raise RuntimeError(f"make -C native failed:\n{r.stdout}\n{r.stderr}")
        from octvr_tpu.runtime.native_io import native_available

        if not native_available():
            raise RuntimeError("native/liboctvr_io.so built but not loadable")
        return "frame reader: native (native/liboctvr_io.so)"

    def remap(self):
        import jax.numpy as jnp

        from octvr_tpu.ops.remap import pack_planes, remap_apply_packed

        rng = np.random.default_rng(0)
        ip = self.mapper.plan.inputs
        worst = {}
        for label, nc, side, plans, dts in (
            ("Y", 1, CAM, [p.remap for p in ip], ("float32", "bfloat16")),
            ("UV", 2, CAM // 2, [p.remap_uv for p in ip], ("float32", "bfloat16")),
        ):
            for plan in plans:
                planes = rng.integers(0, 256, (nc, side, side))
                packed = pack_planes([jnp.asarray(p, jnp.float32) for p in planes])
                flat = planes.reshape(nc, -1)
                ref = np.zeros((nc, plan.idx.shape[1]))
                for k in range(4):
                    ref += flat[:, plan.idx[k]] * plan.w[k].astype(np.float64)
                for dt in dts:
                    out = remap_apply_packed(packed, plan, nc=nc, out_dtype=dt)
                    err = float(
                        np.abs(np.asarray(out, np.float64).reshape(nc, -1) - ref).max()
                    )
                    key = f"{label}/{dt}"
                    worst[key] = max(worst.get(key, 0.0), err)
        for key, err in worst.items():
            tol = TOL_F32 if key.endswith("float32") else TOL_BF16
            if err > tol:
                raise AssertionError(f"remap {key}: max err {err} > {tol}")
        px = sum(int(np.prod(p.remap.out_shape)) for p in ip)
        return (
            f"{px} Y px over 6 inputs vs float64 gather: "
            + ", ".join(f"{k} max {v:.2e}" for k, v in worst.items())
            + f" (tol f32 {TOL_F32}, bf16 {TOL_BF16})"
        )

    def mapper_4k(self):
        import jax

        from octvr_tpu.stitch import Mapper
        from rigs import ground_truth, rgb_from_yuv_buf

        m = self.mapper
        bufs = tuple(jax.device_put(f) for f in self.frames)
        t0 = time.time()
        compiled = m._stitch_auto.lower(m._plan_dev, bufs).compile()
        t_compile = time.time() - t0
        mem = compiled.memory_analysis()
        out, gains = compiled(m._plan_dev, bufs)
        jax.block_until_ready(out)
        # steady state over distinct frame sets
        sets = [
            tuple(jax.device_put(np.clip(f.astype(np.int16) + i, 0, 255).astype(np.uint8)) for f in self.frames)
            for i in range(4)
        ]
        jax.block_until_ready(sets)
        jax.block_until_ready(compiled(m._plan_dev, sets[0]))
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            for s in sets:
                res = compiled(m._plan_dev, s)
        jax.block_until_ready(res)
        ms = (time.perf_counter() - t0) / (reps * len(sets)) * 1e3

        got = rgb_from_yuv_buf(np.asarray(out))
        truth = ground_truth(W4K, H4K)
        pole = H4K // 32  # pole rows are resolution-limited
        err = float(np.abs(got[pole:-pole] - truth[pole:-pole]).mean())
        if err > TOL_WORLD:
            raise AssertionError(f"4K stitch vs world: mean err {err} > {TOL_WORLD}")
        g = np.asarray(gains)
        if np.abs(g - 1.0).max() > TOL_GAIN_UNITY:
            raise AssertionError(f"gains {g} not within {TOL_GAIN_UNITY} of 1")

        other = Mapper(
            self.mt, self.sizes, blend=BLEND, enable_gain=True,
            pipeline="rgb", blend_dtype="float32",
        )
        with jax.default_matmul_precision("highest"):
            out_r, g_r = other.stitch(self.frames)
        y_err = float(np.abs(y_plane(out, H4K) - y_plane(out_r, H4K)).mean())
        if y_err >= TOL_PIPE_Y:
            raise AssertionError(f"defaults vs rgb+float32: Y mean err {y_err}")
        np.testing.assert_allclose(g, np.asarray(g_r), rtol=TOL_PIPE_GAIN, atol=0.01)

        print(f"#   4K step memory_analysis: {mem}", flush=True)
        return (
            f"defaults pipeline={m.plan.pipeline} "
            f"blend_dtype={m.plan.blender.compute_dtype}: vs world mean err "
            f"{err:.3f} (tol {TOL_WORLD}), gains {np.round(g, 4).tolist()}; "
            f"vs rgb+float32 Y mean err {y_err:.3f} (tol {TOL_PIPE_Y}); "
            f"compile {t_compile:.1f}s, steady {ms:.2f} ms/frame, "
            f"temp {mem.temp_size_in_bytes / 2**20:.0f} MiB, "
            f"args {mem.argument_size_in_bytes / 2**20:.0f} MiB"
        )

    def card_vs_cpu(self):
        import jax

        from octvr_tpu.stitch import Mapper
        from octvr_tpu.template import compile_rig

        w, h = SMALL
        mt = compile_rig(self.rig, w, h)
        mt.create_masks()
        outs = {}
        for dev in (jax.devices()[0], jax.devices("cpu")[0]):
            with jax.default_device(dev):
                m = Mapper(mt, self.sizes, blend=BLEND, enable_gain=True)
                out, g = m.stitch(self.frames)
                outs[dev.platform] = (np.asarray(out), np.asarray(g))
        (a, ga), (b, gb) = outs[jax.devices()[0].platform], outs["cpu"]
        d = np.abs(y_plane(a, h) - y_plane(b, h))
        if d.mean() >= TOL_CPU_Y or d.max() > TOL_CPU_Y_MAX:
            raise AssertionError(
                f"card vs CPU at {w}x{h}: Y mean |d| {d.mean()}, max {d.max()}"
            )
        np.testing.assert_allclose(ga, gb, rtol=TOL_SHARD_GAIN)
        return (
            f"{w}x{h} defaults, card vs CPU backend: Y mean |d| {d.mean():.4f} "
            f"(tol {TOL_CPU_Y}), max {d.max():.0f} (tol {TOL_CPU_Y_MAX}), gain max |d| "
            f"{np.abs(ga - gb).max():.1e}"
        )

    def served(self):
        from octvr_tpu.cli.stream import main as stream_main
        from octvr_tpu.template import save_npz

        m = self.mapper
        with tempfile.TemporaryDirectory() as d:
            tmpl = os.path.join(d, "rig.npz")
            save_npz(self.mt, tmpl)
            sets = [
                [np.clip(f.astype(np.int16) + 3 * k - 12, 0, 255).astype(np.uint8) for f in self.frames]
                for k in range(N_STREAM)
            ]
            paths = []
            for i in range(len(self.frames)):
                p = os.path.join(d, f"in{i}.yuv")
                with open(p, "wb") as f:
                    for s in sets:
                        f.write(s[i].tobytes())
                paths.append(p)
            outp = os.path.join(d, "out.yuv")
            stream_main([
                "--inputs", ",".join(paths),
                "--in_size", f"{CAM}x{CAM}",
                "--outputs", f"{tmpl}:{BLEND}",
                "--out", outp,
                "--frames", str(N_STREAM),
                "--drain", "host",
            ])
            got = np.fromfile(outp, dtype=np.uint8).reshape(N_STREAM, H4K * 3 // 2, W4K)
        worst = 0
        for k, s in enumerate(sets):
            ref = np.asarray(m.stitch(s)[0])
            worst = max(worst, int(np.abs(got[k].astype(np.int16) - ref.astype(np.int16)).max()))
        if worst > 1:
            raise AssertionError(f"cli.stream vs Mapper.stitch: max |d| {worst} > 1")
        return f"cli.stream --drain host, {N_STREAM} frames == Mapper.stitch (max |d| {worst} LSB, tol 1)"

    def phone(self):
        import jax
        import jax.numpy as jnp

        from octvr_tpu.ops.color import merge_nv12, split_yuv420p
        from octvr_tpu.stitch import Mapper
        from octvr_tpu.stitch.mapper import FastMapper
        from octvr_tpu.template import compile_rig
        from rigs import render_camera_frames, two_fisheye_rig

        rig = two_fisheye_rig()
        mt = compile_rig(rig, *PHONE)
        mt.create_masks()
        sizes = [(s["options"]["height"], s["options"]["width"]) for s in rig["inputs"]]
        nv12 = [
            np.asarray(merge_nv12(*split_yuv420p(jnp.asarray(f))))
            for f in render_camera_frames(rig)
        ]
        fm = FastMapper(mt, sizes, border=8)
        out = fm.stitch_nv12(nv12)
        ref_m = Mapper(
            mt, sizes, blend=-8, enable_gain=False, frame_format="nv12",
            pipeline="rgb", blend_dtype="float32",
        )
        with jax.default_matmul_precision("highest"):
            ref, _ = ref_m.stitch(nv12)
        h = PHONE[1]
        y_err = float(np.abs(y_plane(out, h) - y_plane(ref, h)).mean())
        if y_err >= TOL_PIPE_Y:
            raise AssertionError(f"FastMapper vs rgb reference: Y mean err {y_err}")
        return (
            f"FastMapper 2 cams NV12 feather ({fm.plan.pipeline}) vs rgb+float32 "
            f"reference at {PHONE[0]}x{PHONE[1]}: Y mean err {y_err:.3f} (tol {TOL_PIPE_Y})"
        )

    def registration(self):
        import copy
        import math

        from octvr_tpu.registration import bundle_adjust_ray, register_images
        from octvr_tpu.registration.bundle_jax import bundle_adjust_ray_jax
        from rigs import render_view, yaw_cameras

        f_wide, f_tele = 320.0, 560.0
        Rs = yaw_cameras(12, 30.0)
        focals = [f_wide if k % 2 == 0 else f_tele for k in range(12)]
        images = [render_view(R, f, 400, 300) for R, f in zip(Rs, focals)]
        res = register_images(images, ba="ray", conf_thresh=0.5, max_features=900, levels=3)
        if len(res.indices) < 11:
            raise AssertionError(f"registered only {res.indices}")
        focs = np.array([c.focal for c in res.cameras])
        rel = np.abs(focs / np.array([focals[i] for i in res.indices]) - 1.0)
        if rel.max() >= TOL_FOCAL:
            raise AssertionError(f"focal errors {rel}")
        worst = 0.0
        for a in range(len(res.indices) - 1):
            ia, ib = res.indices[a], res.indices[a + 1]
            dR = (res.cameras[a + 1].R @ res.cameras[a].R.T) @ (Rs[ib] @ Rs[ia].T).T
            worst = max(worst, math.degrees(math.acos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))
        if worst >= TOL_ANGLE_DEG:
            raise AssertionError(f"neighbour rotation error {worst} deg")

        Rs9 = yaw_cameras(9, 40.0)
        res9 = register_images(
            [render_view(R, 380.0, 400, 300) for R in Rs9],
            ba=None, wave_kind=None, conf_thresh=0.5,
        )
        _, rms_np = bundle_adjust_ray(res9.features, res9.matches, copy.deepcopy(res9.cameras), 0.5)
        _, rms_jx = bundle_adjust_ray_jax(res9.features, res9.matches, copy.deepcopy(res9.cameras), 0.5)
        if abs(rms_np - rms_jx) >= TOL_BA_RMS:
            raise AssertionError(f"BA rms numpy {rms_np} vs jax {rms_jx}")
        return (
            f"12-cam ring: {len(res.indices)} registered, worst neighbour "
            f"rotation {worst:.3f} deg (tol {TOL_ANGLE_DEG}), worst focal "
            f"{rel.max():.3f} (tol {TOL_FOCAL}); 9-cam BA jax vs float64 "
            f"|d rms| {abs(rms_np - rms_jx):.1e} (tol {TOL_BA_RMS})"
        )

    def four_cards(self):
        import jax

        from octvr_tpu.cli.stream import main as stream_main
        from octvr_tpu.parallel.sharded import ShardedMapper, make_mesh
        from octvr_tpu.template import save_npz

        if len(jax.devices()) < 4:
            raise RuntimeError(f"--four-cards needs 4 devices, found {jax.devices()}")
        m = self.mapper  # single card: device 0
        sets = [
            [np.clip(f.astype(np.int16) + 5 * k - 8, 0, 255).astype(np.uint8) for f in self.frames]
            for k in range(4)
        ]
        refs = [m.stitch(s) for s in sets]
        refs = [(np.asarray(o), np.asarray(g)) for o, g in refs]
        lines = []
        for n_data, n_space in ((1, 4), (4, 1)):
            sm = ShardedMapper(self.mt, self.sizes, make_mesh(n_data, n_space), blend=BLEND, enable_gain=True)
            batch = [np.stack([s[i] for s in sets[:n_data]]) for i in range(len(self.frames))]
            t0 = time.time()
            out, gains = sm.stitch_batch(batch)
            out = np.asarray(out)
            t_first = time.time() - t0
            y_worst = g_worst = 0.0
            for b in range(n_data):
                yuv = sm.assemble_yuv(out[b])
                y_worst = max(y_worst, float(np.abs(y_plane(yuv, H4K) - y_plane(refs[b][0], H4K)).mean()))
                g_worst = max(g_worst, float(np.abs(np.asarray(gains)[b] - refs[b][1]).max()))
            if y_worst >= TOL_SHARD_Y or g_worst >= TOL_SHARD_GAIN:
                raise AssertionError(
                    f"ShardedMapper ({n_data}x{n_space}) vs Mapper: Y mean {y_worst}, gain {g_worst}"
                )
            lines.append(
                f"mesh {n_data}x{n_space}: Y mean err {y_worst:.4f} (tol {TOL_SHARD_Y}), "
                f"gain err {g_worst:.1e} (tol {TOL_SHARD_GAIN}), first call {t_first:.1f}s"
            )
        with tempfile.TemporaryDirectory() as d:
            tmpl = os.path.join(d, "rig.npz")
            save_npz(self.mt, tmpl)
            paths = []
            for i in range(len(self.frames)):
                p = os.path.join(d, f"in{i}.yuv")
                with open(p, "wb") as f:
                    for s in sets:
                        f.write(s[i].tobytes())
                paths.append(p)
            outp = os.path.join(d, "out.yuv")
            stream_main([
                "--inputs", ",".join(paths),
                "--in_size", f"{CAM}x{CAM}",
                "--outputs", f"{tmpl}:{BLEND}",
                "--out", outp,
                "--frames", str(len(sets)),
                "--sharded", "1x4",
                "--drain", "host",
            ])
            got = np.fromfile(outp, dtype=np.uint8).reshape(len(sets), H4K * 3 // 2, W4K)
        s_worst = max(
            float(np.abs(y_plane(got[k], H4K) - y_plane(refs[k][0], H4K)).mean())
            for k in range(len(sets))
        )
        if s_worst >= TOL_SHARD_Y:
            raise AssertionError(f"cli.stream --sharded 1x4 vs Mapper: Y mean {s_worst}")
        lines.append(f"cli.stream --sharded 1x4, {len(sets)} frames: Y mean err {s_worst:.4f} (tol {TOL_SHARD_Y})")
        return "; ".join(lines)


def run(four_cards):
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {jax.devices()}", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    print(f"# jax {jax.__version__} devices {jax.devices()} device_kind {dev.device_kind!r}", flush=True)

    from octvr_tpu.utils.compile_cache import enable_compile_cache

    print(f"# compile cache: {enable_compile_cache()}", flush=True)
    t0 = time.time()
    smoke = Smoke()
    print(f"# 4K template compiled in {time.time() - t0:.1f}s", flush=True)
    phases = (
        [("four-cards", smoke.four_cards)]
        if four_cards
        else [
            ("build", smoke.build),
            ("remap", smoke.remap),
            ("mapper-4k", smoke.mapper_4k),
            ("card-vs-cpu", smoke.card_vs_cpu),
            ("served", smoke.served),
            ("phone", smoke.phone),
            ("registration", smoke.registration),
        ]
    )
    failed = []
    for i, (name, fn) in enumerate(phases, 1):
        t0 = time.time()
        try:
            detail = fn()
        except Exception as e:
            traceback.print_exc()
            print(f"phase {i} {name}: FAILED {type(e).__name__}: {e} ({time.time() - t0:.1f}s)", flush=True)
            failed.append(name)
        else:
            print(f"phase {i} {name}: ok {detail} ({time.time() - t0:.1f}s)", flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards",
        action="store_true",
        help="run only the ShardedMapper phase on four cards",
    )
    sys.exit(run(ap.parse_args().four_cards))
