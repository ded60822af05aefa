"""Synthetic test rigs with known analytic structure, and renderers of
what their cameras see (shared by the tests and chip_smoke.py)."""

import math

import numpy as np

PI = math.pi


def two_fisheye_rig():
    """Two opposing full-frame fisheyes with hfov > pi: covers the full
    sphere with overlap bands at lon ~ +-pi/2 (BASELINE config 1)."""
    lens = {
        "width": 1200,
        "height": 1200,
        "hfov": PI * 1.15,
        "center_dx": 0.0,
        "center_dy": 0.0,
        "radial": [0.0, 0.0, 0.0],
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


def six_cam_rig():
    """Six pinhole-like cameras on a cube-face layout with ~100 degree fov:
    full sphere coverage with generous overlaps (BASELINE config 2)."""
    inputs = []
    fov = 1.75  # rad, > pi/2 for overlap
    for yaw in (0, PI / 2, PI, -PI / 2):
        inputs.append(
            {
                "type": "fullframe_fisheye",
                "options": {
                    "width": 800,
                    "height": 800,
                    "hfov": fov,
                    "center_dx": 0.0,
                    "center_dy": 0.0,
                    "radial": [0.0, 0.0, 0.0],
                    "rotation": {"roll": 0.0, "yaw": yaw, "pitch": 0.0},
                },
            }
        )
    for pitch in (PI / 2, -PI / 2):
        inputs.append(
            {
                "type": "fullframe_fisheye",
                "options": {
                    "width": 800,
                    "height": 800,
                    "hfov": 2.2,
                    "center_dx": 0.0,
                    "center_dy": 0.0,
                    "radial": [0.0, 0.0, 0.0],
                    "rotation": {"roll": 0.0, "yaw": 0.0, "pitch": pitch},
                },
            }
        )
    return {
        "output": {"type": "equirectangular", "options": {}},
        "inputs": inputs,
    }


def world_color(ll):
    """Smooth color field on the sphere (analytic ground truth)."""
    lon, lat = ll[..., 0], ll[..., 1]
    r = (np.sin(2 * lon) * 0.5 + 0.5) * 200 + 20
    g = (np.cos(lat) * 0.5 + 0.5) * 200 + 20
    b = (np.sin(lat + lon) * 0.5 + 0.5) * 200 + 20
    return np.stack([r, g, b], -1).astype(np.float32)


def render_camera_frames(rig, exposure_gains=None):
    """Render what each camera sees of the analytic world as YUV420P.
    A camera with a ``vignette`` option sees the world darkened by the
    falloff its template corrects (octvr_tpu/vignette.py)."""
    import jax.numpy as jnp

    from octvr_tpu.cameras import new_camera
    from octvr_tpu.ops.color import rgb_to_yuv420p
    from octvr_tpu.ops.resize import resize_bilinear
    from octvr_tpu.vignette import vignette_map

    frames = []
    for k, spec in enumerate(rig["inputs"]):
        cam = new_camera(spec["type"], spec["options"])
        w = spec["options"].get("width", 800)
        h = spec["options"].get("height", 800)
        xs = (np.arange(w) + 0.5) / w
        ys = (np.arange(h) + 0.5) / h
        grid = np.stack(np.meshgrid(xs, ys), -1)
        ll = cam.image_to_obj(grid)
        rgb = world_color(ll)
        if "vignette" in spec["options"]:
            corr = resize_bilinear(vignette_map(spec["options"]), h, w)
            rgb = rgb / np.asarray(corr)[..., None]
        if exposure_gains is not None:
            rgb = rgb * exposure_gains[k]
        rgb = np.clip(rgb, 0, 255)
        frames.append(np.asarray(rgb_to_yuv420p(jnp.asarray(rgb))))
    return frames


def ground_truth(out_w, out_h):
    from octvr_tpu.cameras import new_camera

    out_cam = new_camera("equirectangular", {})
    xs = np.arange(out_w) / out_w
    ys = np.arange(out_h) / out_h
    gll = out_cam.image_to_obj(np.stack(np.meshgrid(xs, ys), -1))
    return world_color(gll)


def rgb_from_yuv_buf(buf):
    import jax.numpy as jnp

    from octvr_tpu.ops.color import yuv420p_to_rgb

    return np.asarray(yuv420p_to_rgb(jnp.asarray(buf)))


def world_tex(d):
    """Busy, corner-rich color field over cv-convention ray directions
    [..., 3] -> [..., 3] uint8-range floats."""
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    # random per-cell brightness -> L/T junctions everywhere (FAST does
    # not fire on perfect checkerboard X-corners)
    a = np.floor((np.arctan2(x, z) + PI) * 64 / PI)
    b = np.floor((np.arcsin(np.clip(y, -1, 1)) + PI / 2) * 64 / PI)
    # per-cell pseudo-random brightness with large aperiodic variation so
    # corners are locally unique (repetitive textures defeat matching)
    check = ((a * 7919 + b * 104729 + a * b * 337) % 97) / 96.0 * 170 + 30
    r = check + 35 * np.sin(31 * x + 17 * y) + 30 * np.sin(3.1 * x - 1.7 * z)
    g = check + 35 * np.cos(23 * y + 11 * z) + 30 * np.cos(2.3 * y + 1.1 * x)
    bl = check + 35 * np.sin(27 * z + 19 * x) + 30 * np.sin(2.9 * z + 1.3 * y)
    return np.clip(np.stack([r, g, bl], axis=-1), 0, 255)


def render_view(R_cv, f, w, h):
    """Render a pinhole view (cv convention: ray_world = R @ K^-1 p)."""
    u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    d_cam = np.stack(
        [(u - w / 2) / f, (v - h / 2) / f, np.ones_like(u)], axis=-1
    )
    d_world = d_cam @ np.asarray(R_cv).T
    return world_tex(d_world).astype(np.float32)


def yaw_cameras(n, step_deg, f=400.0):
    """Cameras rotated about the world y axis."""
    cams = []
    for k in range(n):
        a = math.radians(step_deg * k)
        R = np.array(
            [
                [math.cos(a), 0, math.sin(a)],
                [0, 1, 0],
                [-math.sin(a), 0, math.cos(a)],
            ]
        )
        cams.append(R)
    return cams
