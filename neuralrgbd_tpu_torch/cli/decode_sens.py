"""Batch-decode ScanNet .sens containers (reference: SensReader/decode.py).

Drives the native streaming decoder over scene lists / split files:
  python -m neuralrgbd_tpu_torch.cli.decode_sens \
      --sens_root /data/scannet_sens --out_root /data/scan-net-5-frame \
      --split_file splits/scannet_train.txt --jobs 4
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import glob
import os
import subprocess
import sys

DEFAULT_BIN = os.path.join(os.path.dirname(__file__), "..", "..",
                           "native", "sensreader", "sens_decode")


def build_parser():
    p = argparse.ArgumentParser(description="ScanNet .sens batch decoder")
    p.add_argument("--sens_root", required=True,
                   help="dir with <scene>/<scene>.sens or <scene>.sens files")
    p.add_argument("--out_root", required=True)
    p.add_argument("--split_file", default=None,
                   help="optional scene-name list to restrict decoding")
    p.add_argument("--frame_inc", type=int, default=5)
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--bin", default=DEFAULT_BIN)
    return p


def find_sens_files(root, split=None):
    files = sorted(glob.glob(os.path.join(root, "**", "*.sens"),
                             recursive=True))
    if split:
        with open(split) as f:
            names = {ln.strip() for ln in f if ln.strip()}
        files = [p for p in files
                 if os.path.splitext(os.path.basename(p))[0] in names]
    return files


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.bin):
        r = subprocess.run(["make", "-C", os.path.dirname(args.bin)])
        if r.returncode != 0:
            sys.exit("cannot build sens_decode (needs g++ + zlib)")

    files = find_sens_files(args.sens_root, args.split_file)
    if not files:
        sys.exit(f"no .sens files under {args.sens_root}")

    def decode(path):
        scene = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.out_root, scene)
        r = subprocess.run([args.bin, path, out, str(args.frame_inc)],
                           capture_output=True, text=True)
        return scene, r.returncode, r.stderr.strip().splitlines()[-1:]

    ok = 0
    with cf.ThreadPoolExecutor(max_workers=args.jobs) as ex:
        for scene, rc, tail in ex.map(decode, files):
            status = "ok" if rc == 0 else f"FAILED({rc})"
            print(f"{scene}: {status} {tail}")
            ok += rc == 0
    print(f"decoded {ok}/{len(files)} scenes -> {args.out_root}")


if __name__ == "__main__":
    main()
