"""Annotate a dataset, image by image:

    python -m crowdsam_tpu_torch.tools.test [-c CONFIG] [--start_idx I]
        [--end_idx J] [-v] [-s SAVE_PATH] [-r LOCAL_RANK] [--mode seg|bbox]
        [--device DEVICE] [key value ...]

Counterpart of the JAX package's `tools/test.py` (reference `tools/test.py`):
the same flags and dotted config overrides, the same per-image dicts
({image_id, num_gt, boxes, scores, categories, rles}) and JSON output, in
`environ.output_dir/result.json` or `--save_path`.  Runs on card
`--local_rank` (cuda:N) unless `--device` names another device; with
neither and no CUDA it raises.  Up to 64 images without crop layers or
`--visualize` go through `CrowdSAM.generate_many`, others through
`generate` one at a time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
from tqdm import tqdm

from crowdsam_tpu_torch.config import load_config, modify_config, \
    resolve_device
from crowdsam_tpu_torch.pipeline.crowdsam import CrowdSAM
from crowdsam_tpu_torch.utils.data import (
    data_meta,
    evaluate_boxes,
    load_img_and_annotation,
)
from crowdsam_tpu_torch.utils.logging import setup_logger
from crowdsam_tpu_torch.utils.visualize import visualize_result


def environ_init(argv=None):
    parser = argparse.ArgumentParser(description="CrowdSAM argparser")
    parser.add_argument("--mode", type=str, choices=["seg", "bbox"],
                        default="seg")
    parser.add_argument("--start_idx", type=int, default=0)
    parser.add_argument("--end_idx", type=int, default=-1)
    parser.add_argument("-c", "--config_file", type=str,
                        default="./configs/crowdhuman.yaml")
    parser.add_argument("-v", "--visualize", action="store_true")
    parser.add_argument("-s", "--save_path", type=str, default="")
    parser.add_argument("-r", "--local_rank", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="device to run on (default: cuda:LOCAL_RANK)")
    parser.add_argument("options", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    configs = modify_config(load_config(args.config_file), args.options)
    np.random.seed(configs["environ"]["seed"])
    os.makedirs(configs["environ"]["output_dir"], exist_ok=True)
    os.makedirs(configs["environ"]["output_dir"] + "/log", exist_ok=True)
    logger = setup_logger(configs["environ"]["output_dir"] + "/log")
    logger.info(str(args))
    return args, configs, logger


def main(argv=None) -> int:
    args, config, logger = environ_init(argv)
    device = resolve_device(args.device, args.local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dataset_path = config["data"]["dataset_root"]
    n_class, class_names = data_meta[config["data"]["dataset"]][1:]

    model = CrowdSAM(config, device=device, logger=logger)
    logger.info("load images and annotations..")
    with open(config["data"]["json_file"]) as f:
        annots = json.load(f)
    end_idx = (len(annots["images"]) if args.end_idx == -1
               else min(args.end_idx, len(annots["images"])))
    image_ids = list(range(args.start_idx, end_idx))
    logger.info(f"total images to process {len(image_ids)}")

    def image_iter():
        for id_ in image_ids:
            yield load_img_and_annotation(dataset_path, annots,
                                          config["data"]["dataset"], id_)

    loaded = list(image_iter()) if len(image_ids) <= 64 else None
    if loaded is not None and model.crop_n_layers == 0 \
            and not args.visualize:
        results = model.generate_many([im for im, _, _ in loaded])
        stream = zip(loaded, results)
    else:
        stream = (((im, gt, iid), model.generate(im))
                  for im, gt, iid in image_iter())

    output_content = []
    for (image, gt_boxes, image_id), result in tqdm(stream,
                                                    total=len(image_ids)):
        instance_dict = {"image_id": image_id, "num_gt": len(gt_boxes) - 1}
        instance_dict.update(
            {k: np.asarray(v).tolist() for k, v in result.items()
             if k in ["boxes", "scores", "categories"]})
        instance_dict.update(
            {k: v for k, v in result.items() if k in ["rles"]})
        output_content.append(instance_dict)
        if args.visualize:
            save_path = os.path.join(config["environ"]["output_dir"],
                                     f"{image_id}.jpg")
            result["gt_boxes"] = gt_boxes
            FP_list, FN_list = evaluate_boxes(
                result["boxes"], result["scores"], gt_boxes, 0.5)[2:]
            visualize_result(
                image, result, class_names, save_path,
                conf_thresh=config["vis"]["vis_thresh"],
                FP_ind=FP_list, FN_ind=FN_list, vis_masks=args.mode == "seg")

    file_path = args.save_path or os.path.join(
        config["environ"]["output_dir"], "result.json")
    if not args.save_path:
        print(f"dump json file to {file_path}")
    with open(file_path, "w") as f:
        json.dump(output_content, f, ensure_ascii=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
