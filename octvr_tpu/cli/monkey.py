"""monkeyVR equivalent: the on-device two-camera NV12 stitcher
(samples/android/monkeyVR/jni/monkey.cpp + codec.cpp roles), headless.

Two NV12 camera feeds are paired by a rendezvous handoff — camera 0
("back") deposits a frame and blocks until camera 1 ("front") pairs it
(monkey.cpp:92-130's mutex/condvar protocol) — then stitched with the
FastMapper NV12 feather profile (mapper_fast.cpp) into a double-buffered
result consumed by a separate encoder/sink thread (codec.cpp's
MediaCodec loop; stitch targets `1 - encoding_result_index`,
monkey.cpp:141-144).

Sinks (codec.cpp:31-45 writes H.264 to an MP4 file or a TCP socket):
  --out FILE         raw NV12 frames appended to FILE ("-" = stdout)
  --tcp HOST:PORT    length-prefixed NV12 frames over a TCP socket
  --h264 FILE.mp4    H.264 via an ffmpeg subprocess (gated: needs ffmpeg
                     on PATH; the image analogue of MediaCodec)

Usage:
  python -m octvr_tpu.cli.monkey -t tmpl.npz --inputs back.nv12,front.nv12 \
      --in_size 640x480 [--frames N] [--fps 30] [--bitrate 4000000] \
      (--out out.nv12 | --tcp 127.0.0.1:9999 | --h264 out.mp4)
"""

import argparse
import os
import queue
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np


class FramePair:
    """The monkey.cpp rendezvous: back deposits + blocks, front pairs.

    Keeps the reference's backpressure semantics — the back camera
    thread cannot run ahead (onFrame returns only after its frame was
    consumed), so the two feeds stay in lockstep without timestamps."""

    def __init__(self):
        self._lock = threading.Lock()
        self._full = threading.Condition(self._lock)
        self._empty = threading.Condition(self._lock)
        self._waiting = None
        self.stopping = False
        self.back_done = False
        self.front_done = False

    def put_back(self, frame):
        with self._lock:
            self._waiting = frame
            self._full.notify_all()
            # also exit when the FRONT feed ends (mirrors pair_front's
            # back_done check): neither feed ordering may park a
            # producer waiting on a consumer that already finished
            while (
                self._waiting is not None
                and not self.stopping
                and not self.front_done
            ):
                self._empty.wait(timeout=0.1)

    def finish_front(self):
        with self._lock:
            self.front_done = True
            self._empty.notify_all()

    def pair_front(self, frame):
        """Returns (back, front), or None when stopping or the back
        feed ended with nothing pending (unequal-length feeds must not
        block the front reader forever)."""
        with self._lock:
            while (
                self._waiting is None
                and not self.stopping
                and not self.back_done
            ):
                self._full.wait(timeout=0.1)
            if self._waiting is None:
                return None
            back = self._waiting
            self._waiting = None
            self._empty.notify_all()
            return back, frame

    def finish_back(self):
        with self._lock:
            self.back_done = True
            self._full.notify_all()

    def stop(self):
        with self._lock:
            self.stopping = True
            self._full.notify_all()
            self._empty.notify_all()


def reader_thread(path, frame_bytes, h, w, pair, index, max_frames):
    """Camera-thread stand-in: feeds raw NV12 frames from a file/pipe."""
    n = 0
    with (sys.stdin.buffer if path == "-" else open(path, "rb")) as f:
        while not pair.stopping and (max_frames <= 0 or n < max_frames):
            buf = f.read(frame_bytes)
            if len(buf) < frame_bytes:
                break
            frame = np.frombuffer(buf, np.uint8).reshape(h * 3 // 2, w)
            if index == 0:
                pair.put_back(frame)
            else:
                res = pair.pair_front(frame)
                if res is None:
                    break
                # bounded put: backpressure reaches the camera threads
                # (the reference stitches inline on the pairing thread)
                while not pair.stopping:
                    try:
                        pair.paired_q.put(res, timeout=0.1)
                        break
                    except queue.Full:
                        continue
            n += 1
    if index == 0:
        pair.finish_back()
    else:
        pair.finish_front()


class RawSink:
    def __init__(self, path):
        self.f = sys.stdout.buffer if path == "-" else open(path, "wb")

    def feed(self, nv12):
        self.f.write(nv12.tobytes())

    def close(self):
        if self.f is not sys.stdout.buffer:
            self.f.close()


class TcpSink:
    """Length-prefixed NV12 frames over TCP (codec.cpp's socket path)."""

    def __init__(self, host, port):
        self.sock = socket.create_connection((host, port), timeout=10)

    def feed(self, nv12):
        data = nv12.tobytes()
        self.sock.sendall(struct.pack("<I", len(data)) + data)

    def close(self):
        self.sock.close()


class H264Sink:
    """ffmpeg subprocess as the MediaCodec analogue (codec.cpp:31-45:
    H.264, 30 fps default, 10 s I-frame interval)."""

    def __init__(self, path, w, h, fps, bitrate):
        if shutil.which("ffmpeg") is None:
            raise SystemExit(
                "--h264 needs ffmpeg on PATH (MediaCodec analogue); "
                "use --out/--tcp for raw NV12"
            )
        self.proc = subprocess.Popen(
            [
                "ffmpeg", "-hide_banner", "-loglevel", "error", "-y",
                "-f", "rawvideo", "-pix_fmt", "nv12",
                "-s", f"{w}x{h}", "-r", str(fps), "-i", "-",
                "-c:v", "libx264", "-b:v", str(bitrate),
                "-g", str(fps * 10), path,
            ],
            stdin=subprocess.PIPE,
        )

    def feed(self, nv12):
        self.proc.stdin.write(nv12.tobytes())

    def close(self):
        self.proc.stdin.close()
        self.proc.wait()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-t", required=True, dest="template")
    ap.add_argument("--inputs", required=True,
                    help="back.nv12,front.nv12 raw NV12 feeds")
    ap.add_argument("--in_size", required=True, help="WxH of each feed")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--bitrate", type=int, default=4_000_000)
    ap.add_argument("--border", type=int, default=8,
                    help="feather border (FastMapper profile)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tcp", default=None)
    ap.add_argument("--h264", default=None)
    args = ap.parse_args(argv)

    paths = args.inputs.split(",")
    if len(paths) != 2:
        raise SystemExit("monkeyVR pairs exactly two camera feeds")
    w, h = (int(v) for v in args.in_size.lower().split("x"))

    from ..runtime.timer import Timer
    from ..stitch import FastMapper
    from ..template import load_dat, load_npz

    if args.template.endswith(".npz"):
        mt = load_npz(args.template)
    else:
        with open(args.template, "rb") as f:
            mt = load_dat(f)
    fm = FastMapper(mt, [(h, w)] * 2, border=args.border)
    W, H = mt.out_size

    if args.tcp:
        host, port = args.tcp.rsplit(":", 1)
        sink = TcpSink(host, int(port))
    elif args.h264:
        sink = H264Sink(args.h264, W, H, args.fps, args.bitrate)
    else:
        sink = RawSink(args.out or "-")

    pair = FramePair()
    pair.paired_q = queue.Queue(maxsize=2)

    frame_bytes = w * h * 3 // 2
    threads = [
        threading.Thread(
            target=reader_thread,
            args=(p, frame_bytes, h, w, pair, i, args.frames),
            daemon=True,
        )
        for i, p in enumerate(paths)
    ]
    for t in threads:
        t.start()

    # encoder thread consumes the double buffer (codec.cpp loop)
    results = [None, None]
    encoding_idx = [-1]
    enc_ev = threading.Event()
    enc_done = threading.Event()
    stop = threading.Event()

    def encoder():
        while not stop.is_set() or encoding_idx[0] >= 0:
            if not enc_ev.wait(timeout=0.1):
                continue
            enc_ev.clear()
            i = encoding_idx[0]
            if i >= 0:
                sink.feed(results[i])
                encoding_idx[0] = -1
                enc_done.set()

    enc_t = threading.Thread(target=encoder, daemon=True)
    enc_t.start()

    n = 0
    t0 = time.time()
    timer = Timer("monkey")
    while True:
        try:
            back, front = pair.paired_q.get(timeout=0.5)
        except queue.Empty:
            if pair.front_done:
                break
            continue
        # stitch into the slot the encoder is NOT holding
        # (monkey.cpp:141-144)
        target = 0 if encoding_idx[0] != 0 else 1
        out = fm.stitch_nv12([back, front])
        results[target] = np.asarray(out)
        while encoding_idx[0] >= 0:  # previous encode still in flight
            enc_done.wait(timeout=0.1)
            enc_done.clear()
        encoding_idx[0] = target
        enc_ev.set()
        n += 1
        timer.tick(f"frame {n}")
        if args.frames and n >= args.frames:
            break

    pair.stop()
    stop.set()
    while encoding_idx[0] >= 0:
        time.sleep(0.01)
    enc_t.join(timeout=5)
    sink.close()
    dt = time.time() - t0
    print(
        f"# {n} frames in {dt:.2f}s ({n / dt if dt else 0:.1f} fps)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
