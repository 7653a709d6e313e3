"""2D volume evaluation entry point of the port (counterpart of
arco_tpu/cli/test_2d.py; reference: test_2D.py).

    python -m arco_torch.cli.test_2d --root_path ../data/ACDC \
        --exp ACDC/arco --labeled_num 7 --iteration 30000

It reads the port's own iter_<N> checkpoints and runs on the card unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from arco_torch import resolve_device
from arco_torch.data.datasets import SliceDataset
from arco_torch.eval.slice2d import (evaluate_2d, model_predictor,
                                     test_single_volume_2d)
from arco_torch.models import net_factory
from arco_torch.train import checkpoint as ckpt


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, default="../data/ACDC")
    p.add_argument("--exp", type=str, default="ACDC/example_training")
    p.add_argument("--model", type=str, default="unet")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--labeled_num", type=int, default=7)
    p.add_argument("--snapshot_dir", type=str, default="../model")
    p.add_argument("--iteration", type=int, default=None,
                   help="checkpoint iteration; default = latest")
    p.add_argument("--startEpoch", type=int, default=None,
                   help="sweep: first checkpoint iteration "
                        "(test_2D.py:140-157 parity)")
    p.add_argument("--endEpoch", type=int, default=None,
                   help="sweep: last checkpoint iteration (inclusive)")
    p.add_argument("--stepEpoch", type=int, default=1000,
                   help="sweep: iteration stride between checkpoints")
    p.add_argument("--input_size", type=int, nargs=2, default=[256, 256])
    p.add_argument("--save_predictions", type=int, default=0,
                   help="write <case>_pred/_img/_gt volumes next to the "
                        "snapshot (npz; .nii.gz when nibabel is available) "
                        "— test_2D.py:93-101 parity")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # the f32 forward of training: no TF32 in convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    snapshot = os.path.join(
        args.snapshot_dir, f"{args.exp}_{args.labeled_num}_labeledfinal",
        args.model)
    steps = ckpt.resolve_steps(snapshot, args.iteration, args.startEpoch,
                               args.endEpoch, args.stepEpoch)
    if len(steps) > 1 and args.save_predictions:
        raise SystemExit("--save_predictions is incompatible with a "
                         "checkpoint sweep; pass --iteration instead")

    model = net_factory(args.model, in_chns=1,
                        class_num=args.num_classes).to(device)

    def make_predict(step):
        model.load_state_dict(ckpt.load_model_params(snapshot, step))
        return model_predictor(model, device)

    dataset = SliceDataset(args.root_path, split="val",
                           list_name="test.list")

    def load(case):
        return dataset.load(dataset.sample_list.index(case))

    # sweep: one line per checkpoint, then the best (the reference prints a
    # table and tracks the best epoch)
    if len(steps) > 1:
        best = None
        for s in steps:
            res = evaluate_2d(dataset.sample_list, load, make_predict(s),
                              args.num_classes, tuple(args.input_size))
            mean = res["mean"].tolist()
            print(json.dumps({"iteration": s, "mean_dice": mean[0],
                              "mean_jc": mean[1], "mean_hd95": mean[2],
                              "mean_asd": mean[3]}))
            if best is None or mean[0] > best[1]:
                best = (s, mean[0])
        print(json.dumps({"best_iteration": best[0],
                          "best_mean_dice": best[1]}))
        return best

    step = steps[0]
    predict = make_predict(step)
    if args.save_predictions:
        from arco_torch.utils.volume_io import save_volume
        save_dir = os.path.join(
            args.snapshot_dir, f"{args.exp}_{args.labeled_num}_labeledfinal",
            f"{args.model}_predictions")
        os.makedirs(save_dir, exist_ok=True)
        all_metrics = []
        for case in dataset.sample_list:
            image, label = load(case)
            metrics, pred = test_single_volume_2d(
                image, label, predict, args.num_classes,
                tuple(args.input_size))
            save_volume(os.path.join(save_dir, f"{case}_pred"), pred)
            save_volume(os.path.join(save_dir, f"{case}_img"), image)
            save_volume(os.path.join(save_dir, f"{case}_gt"), label)
            all_metrics.append(metrics)
        arr = np.asarray(all_metrics)
        result = {"per_class": arr.mean(axis=0),
                  "mean": arr.mean(axis=(0, 1)), "raw": arr}
    else:
        result = evaluate_2d(dataset.sample_list, load, predict,
                             args.num_classes, tuple(args.input_size))
    per_class = result["per_class"].tolist()
    mean = result["mean"].tolist()
    print(json.dumps({"iteration": step, "per_class": per_class,
                      "mean_dice": mean[0], "mean_jc": mean[1],
                      "mean_hd95": mean[2], "mean_asd": mean[3]}))
    return result


if __name__ == "__main__":
    main()
