"""CrowdHuman evaluation (AP / MR / Recall / tp / fp):

    python -m crowdsam_tpu_torch.tools.crowdhuman_eval -d DET_JSON -g GT
        [-o RECORD] [-f] [-v] [-m MODE]

Counterpart of the JAX package's `tools/crowdhuman_eval.py` (reference
`tools/crowdhuman_eval.py:575-595`): the same flags, the same printed
metric lines and the same line appended to the record file.
"""

from __future__ import annotations

import argparse
import sys

from crowdsam_tpu_torch.evallib.crowdhuman import (
    evaluate_predictions_on_crowdhuman,
)

METRIC_NAMES = ["AP", "MR", "Recall", "tp", "fp"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Evaluates predictions in CrowdHuman format "
        "(COCO json or odgt ground truth).")
    parser.add_argument("-d", "--det_path", type=str)
    parser.add_argument("-g", "--gt_path", type=str, default="")
    parser.add_argument("-o", "--output_path", type=str,
                        default="./record.txt")
    parser.add_argument("-f", "--remove_empty_gt", action="store_true")
    parser.add_argument("-v", "--visible_flag", action="store_true")
    parser.add_argument("-m", "--mode", type=int, default=0,
                        choices=(0, 1, 2),
                        help="0: body boxes; 1: head boxes (hbox); 2: joint "
                             "body+head Caltech-union matching")
    args = parser.parse_args(argv)

    eval_results = evaluate_predictions_on_crowdhuman(
        args.gt_path, args.det_path, mode=args.mode,
        remove_empty_gt=args.remove_empty_gt,
        visible_flag=args.visible_flag)
    for k, v in zip(METRIC_NAMES, eval_results):
        print(f"{k}: {v}")
    with open(args.output_path, "a") as f:
        results = [f"{k}: {v:.4f}" for k, v in zip(METRIC_NAMES,
                                                    eval_results)]
        f.write(", ".join(results) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
