"""Annotate a folder, a file or a glob, drawing each result:

    python -m crowdsam_tpu_torch.tools.demo [-c CONFIG] [-i INPUT]
        [-o OUTPUT] [--mode seg|bbox] [--device DEVICE] [key value ...]

Counterpart of the JAX package's `tools/demo.py` (reference
`tools/demo.py`): the same flags, one drawn image per input under OUTPUT
and `OUTPUT/result.json` with {image_file, boxes, scores, categories,
rles}.  Without `-i` it annotates the synthetic 10-shot set
(`data/crowdhuman_train/Images`, written first if absent).  Runs on CUDA
unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np
from PIL import Image
from tqdm import tqdm

from crowdsam_tpu_torch.config import load_config, modify_config, \
    resolve_device
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
from crowdsam_tpu_torch.utils.data import data_meta
from crowdsam_tpu_torch.utils.logging import setup_logger
from crowdsam_tpu_torch.utils.visualize import visualize_result


def environ_init(argv=None):
    parser = argparse.ArgumentParser(description="CrowdSAM demo")
    parser.add_argument("--mode", type=str, choices=["seg", "bbox"],
                        default="seg",
                        help="bbox only shows boxes; seg also shows masks")
    parser.add_argument("-c", "--config_file", type=str,
                        default="./configs/crowdhuman.yaml")
    parser.add_argument("-i", "--input", default=None,
                        help="directory, single image, or glob pattern "
                             "(default: data/crowdhuman_train/Images, "
                             "synthetic fixtures written if absent)")
    parser.add_argument("-o", "--output", type=str, default="demo_out")
    parser.add_argument("--device", default=None,
                        help="device to run on (default: cuda)")
    parser.add_argument("options", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    configs = modify_config(load_config(args.config_file), args.options)
    os.makedirs(args.output, exist_ok=True)
    logger = setup_logger(args.output + "/log")
    if args.input is None:
        from crowdsam_tpu_torch.utils.fixtures import ensure_ten_shot

        args.input = os.path.join(ensure_ten_shot(logger=logger), "Images")
    logger.info(str(args))
    return args, configs, logger


def main(argv=None) -> int:
    args, config, logger = environ_init(argv)
    n_class, class_names = data_meta[config["data"]["dataset"]][1:]
    model = CrowdSAM(config, device=resolve_device(args.device),
                     logger=logger)

    if os.path.isdir(args.input):
        image_files = [os.path.join(args.input, f)
                       for f in sorted(os.listdir(args.input))]
    elif os.path.exists(args.input):
        image_files = [args.input]
    else:
        image_files = glob.glob(os.path.expanduser(args.input))

    output_content = []
    if not image_files:
        logger.warning(
            f"input {args.input!r} matched no files (not a directory, "
            "existing file, or glob with matches)")
    logger.info(f"total images to process {len(image_files)}")
    for image_file in tqdm(image_files):
        image = Image.open(image_file)
        result = model.generate(image)
        instance_dict = {"image_file": image_file}
        instance_dict.update(
            {k: np.asarray(v).tolist() for k, v in result.items()
             if k in ["boxes", "scores", "categories"]})
        instance_dict.update({k: v for k, v in result.items()
                              if k in ["rles"]})
        output_content.append(instance_dict)
        image_name = os.path.basename(image_file).split(".")[0]
        visualize_result(
            image, result, class_names,
            os.path.join(args.output, f"{image_name}.jpg"),
            conf_thresh=config["vis"]["vis_thresh"],
            vis_masks=args.mode == "seg")

    file_path = os.path.join(args.output, "result.json")
    print(f"dump json file to {file_path}")
    with open(file_path, "w") as f:
        json.dump(output_content, f, ensure_ascii=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
