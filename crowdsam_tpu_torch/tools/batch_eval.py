"""Annotate a dataset, convert the result and score it:

    python -m crowdsam_tpu_torch.tools.batch_eval [-n NUM_NODES]
        [-c CONFIG] [--inline] [--device DEVICE] [key value ...]

Counterpart of the JAX package's `tools/batch_eval.py` (reference
`tools/batch_eval.py`): contiguous image shards, one `tools.test` run a
shard writing `temp_result_{rank}.json` in the working directory, the
merge, `convert_to_coco`, then the CrowdHuman evaluator on
`data.odgt_file` (empty images removed, visible boxes), printing AP, MR,
Recall, tp and fp.  With one card, `--inline` or `--device`, the whole
range runs in this process; with more cards, one `tools.test` process a
card (`--local_rank`), up to `-n`.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys

import torch

from crowdsam_tpu_torch.config import load_config, modify_config
from crowdsam_tpu_torch.evallib.coco_convert import convert_to_coco
from crowdsam_tpu_torch.evallib.crowdhuman import (
    evaluate_predictions_on_crowdhuman,
)
from crowdsam_tpu_torch.tools import test as test_cli


def test_argv(start_idx, end_idx, rank, config_file, options, device=None):
    """`tools.test` arguments of one shard."""
    argv = ["--config_file", config_file,
            "--save_path", f"temp_result_{rank}.json",
            "--start_idx", str(start_idx), "--end_idx", str(end_idx),
            "--local_rank", str(rank)]
    if device is not None:
        argv += ["--device", device]
    return argv + list(options)


def run_script(argv) -> None:
    """One shard in its own process."""
    cmd = [sys.executable, "-m", "crowdsam_tpu_torch.tools.test"] + argv
    print(f"Running command: {' '.join(cmd)}")
    subprocess.run(cmd, check=True)


def merge_json(json_files):
    merged = []
    for jf in json_files:
        with open(jf) as f:
            merged.extend(json.load(f))
    for jf in json_files:
        os.remove(jf)
    return merged


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Run sharded evaluation over all available devices")
    parser.add_argument("-n", "--num_nodes", type=int, default=8)
    parser.add_argument("-c", "--config_file",
                        default="./configs/crowdhuman.yaml")
    parser.add_argument("--inline", action="store_true",
                        help="run the whole range in this process")
    parser.add_argument("--device", default=None,
                        help="device of an in-process run (default: cuda)")
    parser.add_argument("options", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    config = modify_config(load_config(args.config_file), args.options)
    import yaml

    print(yaml.dump(config, default_flow_style=False, default_style=""))

    with open(config["data"]["json_file"]) as f:
        gt_js = json.load(f)
    num_imgs = len(gt_js["images"])
    odgt_file = config["data"]["odgt_file"]
    n_devices = torch.cuda.device_count()

    if args.inline or args.device is not None or n_devices < 2:
        test_cli.main(test_argv(0, num_imgs, 0, args.config_file,
                                args.options, args.device))
        json_list = ["temp_result_0.json"]
    else:
        num_nodes = min(args.num_nodes, n_devices)
        batch_size = num_imgs // num_nodes
        with concurrent.futures.ThreadPoolExecutor(num_nodes) as ex:
            futures = []
            for i in range(num_nodes):
                start_idx = i * batch_size
                end_idx = (num_imgs if i == num_nodes - 1
                           else (i + 1) * batch_size)
                futures.append(ex.submit(run_script, test_argv(
                    start_idx, end_idx, i, args.config_file, args.options)))
            for fut in futures:
                fut.result()
        json_list = [f"temp_result_{i}.json" for i in range(num_nodes)]

    merged_result = merge_json(json_list)
    coco_json = convert_to_coco(merged_result, gt_js)
    with open("test.json", "w") as f:
        json.dump(coco_json, f, ensure_ascii=True)

    print("Evaluating..")
    results = evaluate_predictions_on_crowdhuman(
        odgt_file, "test.json", remove_empty_gt=True, visible_flag=True)
    for k, v in zip(["AP", "MR", "Recall", "tp", "fp"], results):
        print(f"{k}: {v}")
    os.remove("test.json")
    print("All processes done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
