"""Auto-calibration CLI: images -> rig JSON (the cv::Stitcher
estimateTransform role as a tool; no PTGui/Hugin project needed).

Usage: python -m octvr_tpu.cli.register -o RIG.json [--ba ray|reproj]
         [--conf X] [--wave horiz|vert|none] IMAGE...
"""

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", required=True, dest="outfile")
    ap.add_argument("--ba", default="ray", choices=["ray", "reproj", "none"])
    ap.add_argument("--conf", type=float, default=1.0)
    ap.add_argument("--wave", default="horiz", choices=["horiz", "vert", "none"])
    ap.add_argument("--features", type=int, default=1500)
    ap.add_argument("images", nargs="+")
    args = ap.parse_args(argv)

    from ..registration import cameras_to_rig, register_images
    from ..utils.png import read_png

    images = [read_png(p)[..., :3] for p in args.images]
    res = register_images(
        images,
        ba=None if args.ba == "none" else args.ba,
        conf_thresh=args.conf,
        max_features=args.features,
        wave_kind=None if args.wave == "none" else args.wave,
    )
    print(
        f"registered {len(res.indices)}/{len(images)} images, "
        f"BA rms {res.rms:.3f}",
        file=sys.stderr,
    )
    sizes = [
        (images[i].shape[1], images[i].shape[0]) for i in res.indices
    ]
    rig = cameras_to_rig(res, sizes)
    rig["source_images"] = [args.images[i] for i in res.indices]
    with open(args.outfile, "w") as f:
        json.dump(rig, f, indent=2)
    print(f"Wrote {args.outfile}", file=sys.stderr)


if __name__ == "__main__":
    main()
