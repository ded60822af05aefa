"""Streaming multi-output stitch pipeline — the AsyncMultiMapper role
(octvr/src/async.{hpp,cpp}).

The reference runs 5 worker threads over blocking queues with triple
buffering (copy-in, H2D, stitch, D2H, copy-out; async.cpp:337-349,
BUF_SIZE=3 :261).  Under JAX the device work is dispatched
asynchronously by the runtime, so the pipeline needs four host stages:

  upload stage:   jax.device_put on a 2-worker pool — two frame sets in
                  flight on separate threads, the pinned-HostMem upload
                  thread analogue (async.cpp:58-68, 263-309); order is
                  preserved by queueing futures, not results
  stitch thread:  dispatch the jitted stitch (returns immediately); the
                  frame buffers are DONATED on their last use so XLA
                  recycles their HBM (HostMem pool reuse, async.cpp:263)
  drain thread:   block on the oldest in-flight output, np.asarray (D2H)

Multiple outputs (multi-region stereo layouts) are one Mapper each with
gain sharing across outputs (gain_modes semantics, async.hpp:79:
-1 = off, k == own index -> solve, k != own -> copy output k's gains).
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from .timer import FpsMeter

BUF_SIZE = 3  # frames in flight, like async.cpp:261
UPLOAD_WORKERS = 2  # in-flight H2D transfers (async.cpp:263-309 pool)

__all__ = ["AsyncMultiMapper", "BUF_SIZE", "UPLOAD_WORKERS"]


class _Stop:
    pass


_STOP = _Stop()


class AsyncMultiMapper:
    """mappers: list of Mapper (one per output region); gain_modes: per
    output, -1 = no compensation, own-index = solve, other-index = reuse
    that output's gains.  donate: recycle frame-buffer HBM via XLA
    donation on each frame's last stitch call (safe here because the
    pipeline never touches a frame set after dispatching it)."""

    def __init__(
        self,
        mappers: List,
        gain_modes: Optional[List[int]] = None,
        timers: bool = False,
        timer_interval: int = 10,
        donate: bool = True,
        drain: str = "host",
    ):
        """drain: "host" downloads each output frame (np.asarray — the
        normal consumer path); "checksum" value-syncs a strided scalar
        reduction instead (forces full device execution, ~8 bytes D2H)
        — the measurement mode for the pipeline's device-bound rate on
        links where frame D2H dominates."""
        import jax

        assert drain in ("host", "checksum")
        self.drain_mode = drain

        self._jax = jax
        self.mappers = mappers
        # sharded outputs (ShardedMapper): the stitch stage groups
        # mesh-'data' consecutive frame sets into one stitch_batch call
        # (BASELINE config 5: live streaming through the sharded
        # mapper); the drain stage fans the batch back out per frame
        # ShardedMapper carries a device mesh; the single-chip Mapper
        # (which also has stitch_batch since round 5) does not
        self._sharded = hasattr(mappers[0], "mesh")
        if self._sharded:
            assert all(hasattr(m, "mesh") for m in mappers), (
                "mixing ShardedMapper and Mapper outputs is unsupported"
            )
            self._data_batch = mappers[0].mesh.shape["data"]
        # donation is a warning no-op on the CPU backend; keep it off
        # there so tests stay quiet
        self.donate = (
            donate
            and not self._sharded
            and jax.default_backend() != "cpu"
        )
        n_out = len(mappers)
        self.gain_modes = (
            list(gain_modes) if gain_modes is not None else list(range(n_out))
        )
        assert len(self.gain_modes) == n_out

        self._closed_input = False
        self._in_q = queue.Queue(maxsize=BUF_SIZE)
        self._up_q = queue.Queue(maxsize=BUF_SIZE)
        self._flight_q = queue.Queue(maxsize=BUF_SIZE)
        self._out_q = queue.Queue(maxsize=BUF_SIZE)
        self.fps = FpsMeter()
        # per-stage phase timers, the mapper.cpp:206-318 / timer.cpp role:
        # host-side ms per stage, printed every timer_interval frames
        self._timers_on = timers
        self._timer_interval = max(1, timer_interval)
        self._stage_ms = {"upload": 0.0, "dispatch": 0.0, "drain": 0.0}
        self._stage_n = 0
        self._pool = ThreadPoolExecutor(
            max_workers=UPLOAD_WORKERS, thread_name_prefix="octvr-upload"
        )
        self._threads = [
            threading.Thread(target=self._run_upload, daemon=True),
            threading.Thread(target=self._run_stitch, daemon=True),
            threading.Thread(target=self._run_drain, daemon=True),
        ]
        for t in self._threads:
            t.start()

    # ----------------------------------------------------------- stages

    def _upload_one(self, item):
        import time

        jax = self._jax
        t0 = time.perf_counter()
        frames = [jax.device_put(f) for f in item]
        jax.block_until_ready(frames)  # H2D boundary (async.cpp:58)
        self._stage_ms["upload"] += (time.perf_counter() - t0) * 1e3
        return frames

    def _run_upload(self):
        """Coordinator: submits uploads to the 2-worker pool and queues
        the FUTURES in arrival order — two H2D transfers proceed
        concurrently while frame order is preserved downstream."""
        while True:
            item = self._in_q.get()
            if isinstance(item, _Stop):
                self._up_q.put(_STOP)
                return
            self._up_q.put(self._pool.submit(self._upload_one, item))

    def _dispatch_sharded(self, pend):
        """One stitch_batch over ``pend`` frame sets (padded by
        repeating the last set when the stream ends mid-batch).  Gain
        modes follow async.cpp:75-91: solve owners first, then copiers
        reuse the owner's per-frame gains device-to-device (the
        exposure_compensate.cpp:315-327 export/inject path — no host
        round trip)."""
        import jax.numpy as jnp

        nreal = len(pend)
        B = self._data_batch
        sets = pend + [pend[-1]] * (B - nreal)
        n_in = len(sets[0])
        per_input = [
            jnp.stack([sets[b][i] for b in range(B)]) for i in range(n_in)
        ]
        n_out = len(self.mappers)
        outs = [None] * n_out
        gains = [None] * n_out
        order = sorted(
            range(n_out),
            key=lambda k: 0 if self.gain_modes[k] in (-1, k) else 1,
        )
        for k in order:
            mode = self.gain_modes[k]
            if mode == -1 or mode == k:
                out, g = self.mappers[k].stitch_batch(per_input)
            else:
                out, g = self.mappers[k].stitch_batch(
                    per_input, gains=gains[mode]
                )
            outs[k] = out
            gains[k] = g
        self._flight_q.put(("sbatch", outs, nreal))

    def _run_stitch(self):
        import time

        if self._sharded:
            pend = []
            while True:
                fut = self._up_q.get()
                if isinstance(fut, _Stop):
                    if pend:
                        self._dispatch_sharded(pend)
                    self._flight_q.put(_STOP)
                    return
                t1 = time.perf_counter()
                pend.append(fut.result())
                if len(pend) == self._data_batch:
                    self._dispatch_sharded(pend)
                    pend = []
                self._stage_ms["dispatch"] += (
                    time.perf_counter() - t1
                ) * 1e3
            return

        while True:
            fut = self._up_q.get()
            if isinstance(fut, _Stop):
                self._flight_q.put(_STOP)
                return
            frames = fut.result()  # resident on device
            t1 = time.perf_counter()
            outs = [None] * len(self.mappers)
            gains = [None] * len(self.mappers)
            # solve owners first, then gain-copiers (async.cpp:75-91)
            order = sorted(
                range(len(self.mappers)),
                key=lambda k: 0 if self.gain_modes[k] in (-1, k) else 1,
            )
            for pos, k in enumerate(order):
                mode = self.gain_modes[k]
                last = pos == len(order) - 1
                don = self.donate and last
                if mode == -1 or mode == k:
                    out, g = self.mappers[k].stitch(frames, donate=don)
                else:
                    out, g = self.mappers[k].stitch(
                        frames, gains=gains[mode], donate=don
                    )
                outs[k] = out
                gains[k] = g
            self._stage_ms["dispatch"] += (time.perf_counter() - t1) * 1e3
            self._flight_q.put(outs)

    def _run_drain(self):
        import sys
        import time

        while True:
            item = self._flight_q.get()
            if isinstance(item, _Stop):
                if getattr(self, "_last_chk", None) is not None:
                    for s in self._last_chk:
                        float(s)  # final value-sync (checksum mode)
                self._out_q.put(_STOP)
                return
            t0 = time.perf_counter()
            if self._sharded:
                _tag, outs, nreal = item
                if self.drain_mode == "checksum":
                    import jax.numpy as jnp

                    # strided scalar per output batch; same amortized
                    # fetch contract as the single-chip branch below
                    scal = [
                        jnp.sum(o[:, ::101, ::103].astype(jnp.int32))
                        for o in outs
                    ]
                    self._last_chk = scal
                    fetch = self._stage_n % 8 >= 8 - nreal
                    vals = (
                        [float(s) for s in scal]
                        if fetch
                        else [0.0 for _ in scal]
                    )
                    for _ in range(nreal):
                        self._stage_n += 1
                        self.fps.tick()
                        self._out_q.put(list(vals))
                    self._stage_ms["drain"] += (
                        time.perf_counter() - t0
                    ) * 1e3
                    continue
                # D2H the whole batch, then reassemble per frame
                host_b = [np.asarray(o) for o in outs]
                for b in range(nreal):
                    host = [
                        m.assemble_yuv(hb[b])
                        for m, hb in zip(self.mappers, host_b)
                    ]
                    self._stage_n += 1
                    self.fps.tick()
                    self._out_q.put(host)
                self._stage_ms["drain"] += (
                    time.perf_counter() - t0
                ) * 1e3
                continue
            if self.drain_mode == "checksum":
                import jax.numpy as jnp

                # one strided scalar per output, dispatched every frame
                # (the device executes every frame); the blocking fetch
                # is amortized over 8 frames, so a dispatch->sync round
                # trip does not serialize the measurement.  The LAST frame always
                # syncs (close()/_STOP path) so end-of-stream wall time
                # covers all device work.
                scal = [
                    jnp.sum(o[::101, ::103].astype(jnp.int32))
                    for o in item
                ]
                self._last_chk = scal
                if self._stage_n % 8 == 7:
                    host = [float(s) for s in scal]
                else:
                    host = [0.0 for _ in scal]
            else:
                host = [np.asarray(o) for o in item]  # blocks until ready
            self._stage_ms["drain"] += (time.perf_counter() - t0) * 1e3
            self._stage_n += 1
            if self._timers_on and self._stage_n % self._timer_interval == 0:
                k = self._timer_interval
                for stage in ("upload", "dispatch", "drain"):
                    print(
                        f"[Timer stitch] {stage}: "
                        f"{self._stage_ms[stage] / k:.2f} ms",
                        file=sys.stderr,
                    )
                    self._stage_ms[stage] = 0.0
            self.fps.tick()
            self._out_q.put(host)

    # ------------------------------------------------------------- API

    def push(self, frames):
        """frames: list of [Hi*3/2, Wi] uint8 YUV420P arrays (one per
        camera).  Blocks when BUF_SIZE frames are in flight."""
        self._in_q.put(list(frames))

    def pop(self):
        """Returns list of per-output YUV420P numpy arrays (blocks).

        CONTRACT CHANGE in ``drain="checksum"`` mode: returns a list of
        per-output floats instead of frames (a strided checksum, 0.0 on
        the 7 of every 8 frames whose fetch is amortized).  That mode
        exists to measure the device-bound pipeline rate on slow D2H
        links — never feed its pop() results to a frame sink
        (cli/stream.py skips its writers in that mode)."""
        out = self._out_q.get()
        if isinstance(out, _Stop):
            raise StopIteration
        return out

    def close_input(self):
        """Signal end-of-stream upstream: flushes any partial sharded
        batch so every pushed frame can still be pop()'d before
        close()."""
        if not self._closed_input:
            self._closed_input = True
            self._in_q.put(_STOP)

    def close(self):
        self.close_input()
        for t in self._threads:
            t.join(timeout=30)
        self._pool.shutdown(wait=False)
