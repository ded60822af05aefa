"""octvr_map equivalent: offline stitch of still images through a
compiled template (apps/octvr/map.cpp role).

Usage: python -m octvr_tpu.cli.map -t TEMPLATE(.dat|.npz) -o OUT.png \
         [--blend N] [--gain] [--cpu] IMAGE...
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-t", required=True, dest="template")
    ap.add_argument("-o", required=True, dest="outfile")
    ap.add_argument(
        "--blend",
        type=int,
        default=128,
        help=">0 multiband width, 0 none, <0 feather border",
    )
    ap.add_argument("--gain", action="store_true")
    ap.add_argument(
        "--cpu", action="store_true", help="CPU remap+seam paste (no jax device)"
    )
    ap.add_argument("images", nargs="+")
    args = ap.parse_args(argv)

    from ..template import load_dat, load_npz
    from ..utils.png import read_png, write_png

    if args.template.endswith(".npz"):
        mt = load_npz(args.template)
    else:
        with open(args.template, "rb") as f:
            mt = load_dat(f)
    imgs = [read_png(p) for p in args.images]
    assert len(imgs) == len(mt.inputs), (
        f"template expects {len(mt.inputs)} inputs, got {len(imgs)}"
    )

    W, H = mt.out_size
    if args.cpu:
        from ..template.compiler import _remap_image_cpu

        canvas = np.zeros((H, W, 3), np.uint8)
        for inp, sm, img in zip(mt.inputs, mt.seam_masks, imgs):
            x, y, rw, rh = inp.roi
            warped = _remap_image_cpu(img[..., :3], inp.map1, inp.map2)
            sel = sm > 128
            canvas[y : y + rh, x : x + rw][sel] = warped[sel]
        write_png(args.outfile, canvas)
    else:
        import jax.numpy as jnp

        from ..ops.color import rgb_to_yuv420p, yuv420p_to_rgb
        from ..stitch import Mapper

        sizes = [img.shape[:2] for img in imgs]
        mapper = Mapper(
            mt, sizes, blend=args.blend, enable_gain=args.gain
        )
        frames = [
            np.asarray(rgb_to_yuv420p(jnp.asarray(img[..., :3].astype(np.float32))))
            for img in imgs
        ]
        out, gains = mapper.stitch(frames)
        rgb = np.asarray(yuv420p_to_rgb(jnp.asarray(np.asarray(out))))
        write_png(args.outfile, np.clip(rgb, 0, 255).astype(np.uint8))
        if args.gain:
            print("gains:", np.asarray(gains), file=sys.stderr)
    print(f"Wrote {args.outfile}", file=sys.stderr)


if __name__ == "__main__":
    main()
