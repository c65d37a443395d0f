"""Dataset conversion CLI: DeepFashion2's per-image annotations to one COCO
file (port of ``seam_match_rcnn_tpu/cli/deepf_to_coco.py``, the reference's
DeepFtoCoco.py usage):

  python -m seam_match_rcnn_tpu_torch.cli.deepf_to_coco \\
      --image_dir data/deepfashion2/train/image \\
      --annos_dir data/deepfashion2/train/annos \\
      --out data/deepfashion2/train/annots.json
"""

from __future__ import annotations

import argparse

from ..data.convert import convert


def build_argparser():
    p = argparse.ArgumentParser("DeepFashion2 -> COCO converter")
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--annos_dir", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--limit", type=int, default=None)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    out = convert(args.image_dir, args.annos_dir, args.out, limit=args.limit)
    print(f"wrote {len(out['images'])} images, {len(out['annotations'])} annotations")
    return out


if __name__ == "__main__":
    main()
