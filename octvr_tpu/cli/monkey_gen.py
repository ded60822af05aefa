"""octvr_monkeygen equivalent: generate feather weight-map PNGs from a
template (apps/octvr/monkey_gen.cpp role — the weights the Android
monkeyVR stitcher consumes).

Usage: python -m octvr_tpu.cli.monkey_gen -t TEMPLATE -o OUT_DIR [--border N]
"""

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-t", required=True, dest="template")
    ap.add_argument("-o", required=True, dest="outdir")
    ap.add_argument("--border", type=int, default=8)
    args = ap.parse_args(argv)

    from ..stitch.blenders import build_feather_plan
    from ..template import load_dat, load_npz
    from ..utils.png import write_png

    if args.template.endswith(".npz"):
        mt = load_npz(args.template)
    else:
        with open(args.template, "rb") as f:
            mt = load_dat(f)

    plan = build_feather_plan(
        [i.mask for i in mt.inputs],
        [i.roi for i in mt.inputs],
        args.border,
    )
    os.makedirs(args.outdir, exist_ok=True)
    for i, w in enumerate(plan.weights):
        png = np.clip(np.round(w * 255.0), 0, 255).astype(np.uint8)
        write_png(os.path.join(args.outdir, f"weight_{i}.png"), png)
        print(f"weight_{i}.png {png.shape[1]}x{png.shape[0]}")


if __name__ == "__main__":
    main()
