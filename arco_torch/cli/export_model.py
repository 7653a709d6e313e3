"""Export a trained checkpoint as a self-contained serving artifact
(counterpart of arco_tpu/cli/export_model.py).

    python -m arco_torch.cli.export_model \
        --exp ACDC/arco --labeled_num 7 --iteration 30000 \
        --out unet_acdc.pt2 --batch dynamic

The artifact is a ``torch.export`` program with its weights
(``torch.export.save``); a serving host loads it with
``arco_torch.export.load_predictor`` (or ``torch.export.load``) without the
model-zoo code or a checkpoint. JAX's ``--platforms`` gives way to
``--device``, the device the program is traced on (``load_predictor``
moves it to another). ``--dims 3`` takes the port's 3-D layout: the input
is [B, C, *input_size]. The reference has no analog: its deploy path
re-imports the network class and torch-loads the .pth
(test_2D.py:117-122).
"""

from __future__ import annotations

import argparse
import os

import torch

from arco_torch import resolve_device
from arco_torch.export import export_predictor, input_spec, save_predictor
from arco_torch.models import net_factory, net_factory_3d
from arco_torch.train import checkpoint as ckpt


def _spec(shape, dtype) -> str:
    """e.g. float32[s0, 1, 256, 256] (s0: a symbolic batch)."""
    return f"{str(dtype).replace('torch.', '')}{list(shape)}"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--exp", type=str, default="ACDC/example_training")
    p.add_argument("--model", type=str, default="unet")
    p.add_argument("--dims", type=int, choices=[2, 3], default=2,
                   help="2 -> net_factory (unet zoo), 3 -> net_factory_3d "
                        "(vnet zoo, [B, C, X, Y, Z] inputs)")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--in_chns", type=int, default=1)
    p.add_argument("--labeled_num", type=int, default=7)
    p.add_argument("--snapshot_dir", type=str, default="../model")
    p.add_argument("--iteration", type=int, default=None,
                   help="checkpoint iteration; default = latest")
    p.add_argument("--input_size", type=int, nargs="+", default=[256, 256],
                   help="spatial size (2 ints for 2D, 3 for 3D)")
    p.add_argument("--batch_size", type=int, default=8,
                   help="exported batch (ignored with --batch dynamic)")
    p.add_argument("--batch", choices=["static", "dynamic"],
                   default="static")
    p.add_argument("--output", choices=["argmax", "softmax", "logits"],
                   default="argmax")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device the program is traced on")
    p.add_argument("--out", type=str, required=True)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    # the f32 forward of training: no TF32 in convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    snapshot = os.path.join(
        args.snapshot_dir, f"{args.exp}_{args.labeled_num}_labeledfinal",
        args.model)
    step = (args.iteration if args.iteration is not None
            else ckpt.latest_step(snapshot))
    if step is None:
        raise SystemExit(f"no checkpoints under {snapshot}")
    if len(args.input_size) != args.dims:
        raise SystemExit(f"--input_size needs {args.dims} ints for "
                         f"--dims {args.dims}")
    if args.dims == 2:
        model = net_factory(args.model, in_chns=args.in_chns,
                            class_num=args.num_classes,
                            img_size=tuple(args.input_size))
    else:
        model = net_factory_3d(args.model, in_chns=args.in_chns,
                               class_num=args.num_classes)
    model.load_state_dict(ckpt.load_model_params(snapshot, step))
    shape = (args.batch_size, args.in_chns, *args.input_size)
    exported = export_predictor(model, shape, output=args.output,
                                batch=args.batch, device=device)
    save_predictor(args.out, exported)
    size_mb = os.path.getsize(args.out) / 1e6
    out_node = [n for n in exported.graph.nodes if n.op == "output"][0]
    outs = [_spec(a.meta["val"].shape, a.meta["val"].dtype)
            for a in out_node.args[0]]
    print(f"exported iter_{step} -> {args.out} "
          f"({size_mb:.1f} MB, device={device}, "
          f"in={[_spec(*input_spec(exported))]}, out={outs})")


if __name__ == "__main__":
    main()
