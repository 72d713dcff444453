"""Run DSO visual odometry over a capture folder (reference: run_dso.py;
counterpart of ``neuralrgbd_tpu/cli/run_dso.py``, on the port's ``pose.dso``).

DSO wants one image type per directory, so images matching --img_glob are
copied/linked into a temp dir first (run_dso.py:48-56).
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import tempfile


def build_parser():
    p = argparse.ArgumentParser(description="DSO driver")
    p.add_argument("--img_glob", type=str, required=True)
    p.add_argument("--intrin_path", type=str, required=True,
                   help=".mat/.json/.npz with IntM + img_size")
    p.add_argument("--dso_bin_path", type=str,
                   default="third_party/dso/build/bin/dso_dataset")
    p.add_argument("--result_path", type=str, default="./result.txt")
    p.add_argument("--mode", type=int, default=1)
    p.add_argument("--preset", type=int, default=2)
    p.add_argument("--crop_w", type=int, default=640)
    p.add_argument("--crop_h", type=int, default=480)
    p.add_argument("--max_frame", type=int, default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from neuralrgbd_tpu_torch.data.mdata import load_intrinsics_file
    from neuralrgbd_tpu_torch.pose.dso import run_dso

    K, img_size = load_intrinsics_file(args.intrin_path)
    imgs = sorted(glob.glob(args.img_glob))
    if not imgs:
        raise FileNotFoundError(f"no images match {args.img_glob!r}")

    with tempfile.TemporaryDirectory(prefix="dso_imgs_") as tmp:
        for i, src in enumerate(imgs):
            ext = os.path.splitext(src)[1]
            dst = os.path.join(tmp, f"{i:06d}{ext}")
            try:
                os.symlink(os.path.abspath(src), dst)
            except OSError:
                shutil.copy(src, dst)
        poses = run_dso(
            tmp, K, img_size,
            dso_bin_path=args.dso_bin_path,
            crop_size=(args.crop_w, args.crop_h),
            result_path=args.result_path,
            mode=args.mode, preset=args.preset,
            max_frame=args.max_frame,
            workdir=os.path.dirname(os.path.abspath(args.result_path)) or ".",
        )
    n_valid = sum(1 for p in poses if not isinstance(p, int))
    print(f"DSO: {n_valid}/{len(poses)} valid poses -> {args.result_path}")


if __name__ == "__main__":
    main()
