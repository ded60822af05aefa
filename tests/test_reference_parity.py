"""Reference-parity harness (VERDICT r1 item 5).

(a) A fixture ``.dat`` written FIELD BY FIELD by an independent writer
    following the reference's serializer (template.cpp:206-256: magic
    "VRv11", int64-LE scalars, rect as 4x i64, mats as type/rows/cols +
    raw row-major bytes) — proves ``template.io.load_dat`` reads what
    the reference's octvr_dump writes, not merely its own output.
(b) An f64 CPU golden of the full per-frame pipeline (YUV in -> vignette
    -> remap -> gain solve/apply -> multiband blend -> YUV out) compared
    against the jitted Mapper at <= 1/255 mean.
(c) A PTGui-schema project through tools/ptx2json.py -> compile_rig ->
    stitch.
"""

import math
import struct
import subprocess
import sys
import os

import numpy as np
import pytest

import jax.numpy as jnp

from octvr_tpu.ops.color import split_yuv420p
from octvr_tpu.ops.pyramid import down_matrix, up_matrix
from octvr_tpu.stitch import Mapper
from octvr_tpu.stitch.gain import ALPHA
from octvr_tpu.template import compile_rig
from octvr_tpu.template.compiler import _remap_image_cpu
from octvr_tpu.template.io import load_dat

from rigs import two_fisheye_rig
from test_stitch import render_camera_frames

PI = math.pi
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------- (a) .dat

CV_8U = 0
CV_32F = 5


def _write_reference_dat(path, out_size, inputs, seam_masks, overlays=()):
    """Independent re-implementation of MapperTemplate::dump
    (reference template.cpp:206-256), sharing no code with
    octvr_tpu.template.io."""
    with open(path, "wb") as f:
        f.write(b"VRv11")

        def w64(v):
            f.write(struct.pack("<q", int(v)))

        def wmat(m, cvtype):
            if m is None:
                w64(cvtype), w64(0), w64(0)
                return
            w64(cvtype)
            w64(m.shape[0])
            w64(m.shape[1])
            f.write(np.ascontiguousarray(m).tobytes())

        w64(out_size[0])
        w64(out_size[1])
        w64(len(inputs))
        for roi, m1, m2, mask, vig in inputs:
            for v in roi:
                w64(v)
            wmat(m1, CV_32F)
            wmat(m2, CV_32F)
            wmat(mask, CV_8U)
            wmat(vig, CV_32F)
        for sm in seam_masks:
            wmat(sm, CV_8U)
        w64(len(overlays))
        for roi, m1, m2, mask, vig in overlays:
            for v in roi:
                w64(v)
            wmat(m1, CV_32F)
            wmat(m2, CV_32F)
            wmat(mask, CV_8U)
            wmat(vig, CV_32F)


def test_load_reference_dat_and_stitch(tmp_path):
    """Hand-written VRv11 bytes -> load_dat -> Mapper -> output matches
    the f64 CPU remap of the same maps."""
    W, H = 128, 64
    in_h, in_w = 64, 64

    def linear_maps(x0, x1):
        # output cols [x0, x1) map linearly across the input; rows map
        # to rows.  Normalized map convention: px = map * in_w - 0.5.
        m1 = np.full((H, x1 - x0), -1.0, dtype=np.float32)
        m2 = np.full((H, x1 - x0), -1.0, dtype=np.float32)
        cols = (np.arange(x0, x1) - x0 + 0.5) / (x1 - x0)
        rows = (np.arange(H) + 0.5) / H
        m1[:] = cols[None, :]
        m2[:] = rows[:, None]
        return m1, m2

    # two inputs with a 16-col overlap
    rois = [(0, 0, 72, H), (56, 0, 72, H)]
    inputs = []
    seams = []
    for (x, y, w, h) in rois:
        m1, m2 = linear_maps(x, x + w)
        mask = np.full((h, w), 255, dtype=np.uint8)
        vig = None  # empty mat in the stream
        inputs.append(((x, y, w, h), m1, m2, mask, vig))
    # seam: split the overlap at col 64
    s0 = np.zeros((H, 72), np.uint8)
    s0[:, : 64 - 0] = 255
    s1 = np.zeros((H, 72), np.uint8)
    s1[:, 64 - 56 :] = 255
    seams = [s0, s1]

    path = tmp_path / "fixture.dat"
    _write_reference_dat(path, (W, H), inputs, seams)

    with open(path, "rb") as f:
        mt = load_dat(f)
    assert mt.out_size == (W, H)
    assert len(mt.inputs) == 2 and len(mt.seam_masks) == 2
    assert mt.inputs[0].vignette is None
    np.testing.assert_array_equal(mt.inputs[1].map1, inputs[1][1])

    # smooth in-gamut frames (random noise YUV clips out of gamut in
    # RGB, breaking the Y roundtrip this test relies on)
    frames = []
    for k in range(2):
        yy, xx = np.meshgrid(
            np.linspace(0, 2, in_h), np.linspace(0, 3, in_w), indexing="ij"
        )
        y = (128 + 90 * np.sin(xx + k) * np.cos(yy)).astype(np.uint8)
        u = np.full((in_h // 2, in_w // 2), 128, np.uint8)
        v = np.full((in_h // 2, in_w // 2), 128, np.uint8)
        frames.append(
            np.concatenate([y, np.concatenate([u, v], axis=1)], axis=0)
        )
    mapper = Mapper(mt, [(in_h, in_w)] * 2, blend=0, enable_gain=False)
    out, _ = mapper.stitch(frames)
    y_out = np.asarray(out)[:H]

    # golden: f64 remap of the Y plane through the same maps
    for (x, y, w, h), inp, fr in zip(rois, mt.inputs, frames):
        y_in = fr[:in_h].astype(np.float64)
        ref = _remap_image_cpu(y_in, inp.map1, inp.map2)
        got = y_out[y : y + h, x : x + w].astype(np.float64)
        m = inp.mask > 0
        # blend=0 paste order: later inputs overwrite; test each input's
        # exclusive region
        if x == 0:
            m = m & (np.arange(x, x + w)[None, :] < 56)
        lum_err = np.abs(got - ref)[m]
        # Y passes through RGB and back: BT.601 roundtrip + u8 rounding
        assert lum_err.mean() < 1.5, lum_err.mean()


# ----------------------------------------------------- (b) f64 CPU golden


def _yuv_to_rgb_f64(buf):
    y, u, v = split_yuv420p(np.asarray(buf))
    yf = y.astype(np.float64)
    uf = np.repeat(np.repeat(u.astype(np.float64), 2, 0), 2, 1) - 128.0
    vf = np.repeat(np.repeat(v.astype(np.float64), 2, 0), 2, 1) - 128.0
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    return np.clip(np.stack([r, g, b]), 0.0, 255.0)


def _rgb_to_yuv_f64(rgb):
    r, g, b = rgb
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    def box2(c):
        cr = (c[0::2] + c[1::2]) * 0.5
        return (cr[:, 0::2] + cr[:, 1::2]) * 0.5

    yq = np.clip(np.round(y), 0, 255).astype(np.uint8)
    uq = np.clip(np.round(box2(u)), 0, 255).astype(np.uint8)
    vq = np.clip(np.round(box2(v)), 0, 255).astype(np.uint8)
    return np.concatenate([yq, np.concatenate([uq, vq], axis=1)], axis=0)


def _pipeline_golden_f64(mapper, mt, frames):
    """NumPy f64 twin of Mapper._forward (YUV in -> YUV out)."""
    plan = mapper.plan
    n = mapper.num_inputs
    W, H = plan.canvas_size

    warped = []
    for buf, ip, inp in zip(frames, plan.inputs, mt.inputs):
        rgb = _yuv_to_rgb_f64(buf)
        if ip.vignette is not None:
            rgb = np.clip(rgb * ip.vignette.astype(np.float64)[None], 0, 255)
        q = np.clip(np.round(rgb), 0, 255)  # pack_planes 8-bit quantization
        warped.append(
            np.stack(
                [_remap_image_cpu(q[c], inp.map1, inp.map2) for c in range(3)]
            )
        )

    gains = np.ones(n)
    gp = plan.gain
    if gp is not None:
        norms = []
        for wimg, ip in zip(warped, plan.inputs):
            oy, ox, s, wh, ww = ip.work_sub
            sub = wimg[:, oy : oy + wh * s, ox : ox + ww * s]
            while s > 1:  # box-mean pooling, same halving order as jit
                sub = (sub[:, 0::2, :] + sub[:, 1::2, :]) * 0.5
                sub = (sub[:, :, 0::2] + sub[:, :, 1::2]) * 0.5
                s >>= 1
            norms.append(np.sqrt((sub**2).sum(axis=0)))
        I = np.zeros((n, n))
        for (i, j), mi, mj in zip(gp.pairs, gp.masks_i, gp.masks_j):
            cnt = float(gp.N[i][j])
            I[i, j] = (norms[i] * mi.astype(np.float64)).sum() / cnt
            I[j, i] = (norms[j] * mj.astype(np.float64)).sum() / cnt
        Nf = np.array(gp.N, dtype=np.float64)
        off = 1.0 - np.eye(n)
        A = (
            np.asarray(gp.A_static, np.float64)
            + np.diag((2 * ALPHA * I * I * Nf * off).sum(1))
            - 2 * ALPHA * I * I.T * Nf * off
        )
        gains = np.linalg.solve(A, np.asarray(gp.b, np.float64))
        warped = [w * g for w, g in zip(warped, gains)]

    bl = plan.blender
    B = bl.num_bands
    arx, ary, arw, arh = bl.align_result_roi

    def down(z):
        kv = down_matrix(z.shape[1]).astype(np.float64)
        kh = down_matrix(z.shape[2]).astype(np.float64)
        return np.einsum("oh,chw->cow", kv, np.einsum("pw,chw->chp", kh, z))

    def up(z):
        kv = up_matrix(z.shape[1]).astype(np.float64)
        kh = up_matrix(z.shape[2]).astype(np.float64)
        return np.einsum("oh,chw->cow", kv, np.einsum("pw,chw->chp", kh, z))

    dst = [np.zeros((3, arh >> i, arw >> i)) for i in range(B + 1)]
    for img, roi, aroi, wpyr in zip(warped, bl.rois, bl.align_rois, bl.weight_pyrs):
        x, y, w, h = roi
        ax, ay, aw, ah = aroi
        src0 = np.zeros((3, ah, aw))
        src0[:, y - ay : y - ay + h, x - ax : x - ax + w] = img
        gauss = [src0]
        for _ in range(B):
            gauss.append(down(gauss[-1]))
        for i in range(B + 1):
            lap = gauss[i] - up(gauss[i + 1]) if i < B else gauss[B]
            contrib = lap * np.asarray(wpyr[i], np.float64)[None]
            ox, oy = (ax - arx) >> i, (ay - ary) >> i
            dst[i][:, oy : oy + (ah >> i), ox : ox + (aw >> i)] += contrib
    for i in range(B + 1):
        # the jitted path multiplies by the plan's reciprocal weights;
        # mirror that exactly in the golden
        dst[i] = dst[i] * np.asarray(bl.inv_band_weights[i], np.float64)[None]
    acc = dst[B]
    for i in range(B - 1, -1, -1):
        acc = up(acc) + dst[i]

    canvas = np.zeros((3, H, W))
    cw = min(arw, W - arx)
    ch = min(arh, H - ary)
    canvas[:, ary : ary + ch, arx : arx + cw] = acc[:, :ch, :cw]
    canvas = np.clip(canvas, 0, 255)
    return _rgb_to_yuv_f64(canvas), gains


@pytest.mark.parametrize("canvas", [(256, 128), (1024, 512)])
def test_f64_golden_full_pipeline(canvas):
    """1024x512 uses working-grid stride 2 (box-pooled gain images);
    256x128 runs at stride 1."""
    W, H = canvas
    rig = two_fisheye_rig()
    for spec in rig["inputs"]:
        spec["options"]["width"] = 256
        spec["options"]["height"] = 256
        spec["options"]["vignette"] = [1.0, -0.15, 0.05, 0.0]
    mt = compile_rig(rig, W, H)
    mt.create_masks()
    sizes = [(256, 256)] * 2
    frames = render_camera_frames(rig)

    mapper = Mapper(mt, sizes, blend=16, enable_gain=True)
    if W == 1024:
        assert mapper.plan.inputs[0].work_sub[2] > 1  # pooled path
    out, gains_jit = mapper.stitch(frames)
    out = np.asarray(out)

    golden, gains_f64 = _pipeline_golden_f64(mapper, mt, frames)

    np.testing.assert_allclose(
        np.asarray(gains_jit), gains_f64, rtol=2e-3
    )
    err = np.abs(out.astype(np.float64) - golden.astype(np.float64))
    assert err.mean() <= 1.0, f"mean abs err {err.mean()} bytes"
    assert np.percentile(err, 99) <= 3.0, np.percentile(err, 99)


# ------------------------------------------------------------ (c) PTGui


PTS_PROJECT = """# ptGui project file
#-imgfile 256 256
o w256 h256 f3 v190 r0 p0 y0 a0 b0 c0 d0 e0 Va1 Vb-0.1 Vc0 Vd0 Eev0
#-imgfile 256 256
o w256 h256 f3 v190 r0 p0 y180 a0 b0 c0 d0 e0 Va1 Vb-0.1 Vc0 Vd0 Eev0
"""


def test_ptgui_project_to_stitch(tmp_path):
    proj = tmp_path / "rig.pts"
    proj.write_text(PTS_PROJECT)
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "ptx2json.py"), str(proj)],
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    import json

    rig = json.loads(res.stdout)
    assert len(rig["inputs"]) == 2
    assert rig["inputs"][0]["type"] == "fullframe_fisheye"

    mt = compile_rig(rig, 256, 128)
    mt.create_masks()
    sizes = [(256, 256)] * 2
    frames = render_camera_frames(rig)
    mapper = Mapper(mt, sizes, blend=-8, enable_gain=False)
    out, _ = mapper.stitch(frames)
    y = np.asarray(out)[:128]
    # full coverage: the two 190-degree fisheyes span the sphere
    assert (y > 0).mean() > 0.98
