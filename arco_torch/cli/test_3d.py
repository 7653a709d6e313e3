"""3D sliding-window evaluation entry point of the port (counterpart of
arco_tpu/cli/test_3d.py; reference: test_3D.py).

    python -m arco_torch.cli.test_3d --root_path ../data/LA --exp LA/arco

It reads the port's own iter_<N> checkpoints, one (default: the newest) or
a sweep (--startEpoch/--endEpoch/--stepEpoch, test_3D.py:39-41), and runs on
the card unless given ``--device cpu``, in f32 without TF32. With
``--device_eval 1`` (the default) each case stays on the device
(eval/sliding_window_device.py); 0 sums the window scores on the host.
"""

from __future__ import annotations

import argparse
import functools
import json
import os

import torch

from arco_torch import resolve_device
from arco_torch.data.datasets import LAHeartDataset
from arco_torch.eval.sliding_window import evaluate_3d, model_predictor
from arco_torch.eval.sliding_window_device import test_single_case_3d_device
from arco_torch.models import net_factory_3d
from arco_torch.train import checkpoint as ckpt


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--root_path", type=str, default="../data/LA")
    p.add_argument("--exp", type=str, default="LA/example")
    p.add_argument("--model", type=str, default="vnet")
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--labeled_num", type=int, default=8)
    p.add_argument("--snapshot_dir", type=str, default="../model")
    p.add_argument("--iteration", type=int, default=None)
    p.add_argument("--startEpoch", type=int, default=None,
                   help="sweep: first checkpoint iteration")
    p.add_argument("--endEpoch", type=int, default=None,
                   help="sweep: last checkpoint iteration (inclusive)")
    p.add_argument("--stepEpoch", type=int, default=1000,
                   help="sweep: iteration stride")
    p.add_argument("--patch_size", type=int, nargs=3, default=[112, 112, 80])
    p.add_argument("--stride_xy", type=int, default=18)
    p.add_argument("--stride_z", type=int, default=4)
    p.add_argument("--nms", type=int, default=0)
    p.add_argument("--device_eval", type=int, default=1,
                   help="1: each case on the device "
                        "(eval/sliding_window_device.py); 0: window scores "
                        "summed on the host")
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
    model = net_factory_3d(args.model, in_chns=1,
                           class_num=args.num_classes).to(device)
    dataset = LAHeartDataset(args.root_path, split="test")

    def load(case):
        return dataset.load(dataset.sample_list.index(case))

    case_fn = functools.partial(test_single_case_3d_device, device=device) \
        if args.device_eval else None
    best = result = None
    for s in steps:
        model.load_state_dict(ckpt.load_model_params(snapshot, s))
        result = evaluate_3d(dataset.sample_list, load,
                             model_predictor(model, device), args.num_classes,
                             tuple(args.patch_size), args.stride_xy,
                             args.stride_z, use_nms=bool(args.nms),
                             case_fn=case_fn)
        mean = result["mean"].tolist()
        print(json.dumps({"iteration": s, "mean_dice": mean[0],
                          "mean_jc": mean[1], "mean_hd95": mean[2],
                          "mean_asd": mean[3]}))
        if best is None or mean[0] > best[1]:
            best = (s, mean[0])
    if len(steps) > 1:
        print(json.dumps({"best_iteration": best[0],
                          "best_mean_dice": best[1]}))
        return best
    return result


if __name__ == "__main__":
    main()
