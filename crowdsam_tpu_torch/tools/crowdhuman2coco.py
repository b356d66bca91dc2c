"""CrowdHuman odgt -> COCO json:

    python -m crowdsam_tpu_torch.tools.crowdhuman2coco [-d DATA] [-o ODGT]
        [-s SAVE] [-v] [-f 0|1] [--tag TAG] [--shuffle] [--size N]

Counterpart of the JAX package's `tools/crowdhuman2coco.py` (reference
`tools/crowdhuman2coco.py`), with its flags; the images are read from
`DATA/Images/<ID>.jpg` for their sizes.
"""

from __future__ import annotations

import argparse
import os
import sys

from crowdsam_tpu_torch.evallib.coco_convert import crowdhuman2coco


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("-d", "--data-path", default="dataset/crowdhuman")
    parser.add_argument("-o", "--odgt-path", default="annotation_val.odgt")
    parser.add_argument("-s", "--save-path", default="val.json")
    parser.add_argument("-v", "--visible", action="store_true",
                        help="use visible boxes")
    parser.add_argument("-f", "--full", default=1, type=int,
                        help="use full boxes")
    parser.add_argument("--tag", default="person", type=str,
                        help="'person', 'mask', or 'both'")
    parser.add_argument("--shuffle", action="store_true")
    parser.add_argument("--size", default=999999999, type=int)
    args = parser.parse_args(argv)

    crowdhuman2coco(
        odgt_path=os.path.join(args.data_path, args.odgt_path),
        json_path=os.path.join(args.data_path, args.save_path),
        image_dir=os.path.join(args.data_path, "Images"),
        visible=args.visible,
        full=bool(args.full),
        tag=args.tag,
        shuffle=args.shuffle,
        max_images=args.size,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
