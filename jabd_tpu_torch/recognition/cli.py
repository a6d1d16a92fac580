"""Recognition command line of the port.

Port of `jabd_tpu/recognition/cli.py`, with its flags and defaults, on the
card unless `--device cpu` is given:

  python -m jabd_tpu_torch.recognition.cli train    --data-root faces/ [--device-augment] [--precision 16]
  python -m jabd_tpu_torch.recognition.cli verify   --data-dir val/
  python -m jabd_tpu_torch.recognition.cli tinyface --tinyface-root tf/
  python -m jabd_tpu_torch.recognition.cli extract  --image-list l.txt --out-dir f/
  python -m jabd_tpu_torch.recognition.cli ijbs     --features f/features.npz --protocol-dir p/
  python -m jabd_tpu_torch.recognition.cli export   --out art/ [--fold] [--quantize int8]

`--ckpt` takes a reference AdaFace `.pth`/`.tar`/`.ckpt` (its names mapped
by recognition/torch_convert.py) or a state dict of the port saved with
`torch.save`; without it the weights are a seeded random init and a
`[warn]` says so. `train` writes `<checkpoint-dir>/<epoch>.pt` with the
backbone's state dict under "model", which `--ckpt` of the other commands
reads. `train --shard-head [--fsdp]` trains with the head sharded along
classes over the process group (`python -m torch.distributed.run
--nproc-per-node N -m jabd_tpu_torch.recognition.cli train --shard-head
...`; recognition/parallel.py), the backbone FSDP-sharded with --fsdp;
alone it is the plain step. `extract --data-parallel` splits each batch
over a local mesh: one replica per card, or per comma-separated --device
entry (`--device cpu,cpu`).
"""

from __future__ import annotations

import argparse
import json
import sys

def calibration_faces(n: int = 8, size: int = 112):
    """[n, 3, size, size] normalized random faces, seeded: the
    self-calibration input of `--quantize int8` (serving inputs are
    (x / 255 - 0.5) / 0.5, so the absmax envelope needs little data)."""
    import numpy as np
    import torch

    x = np.random.default_rng(0).integers(0, 256, (n, size, size, 3)).astype(np.float32)
    return torch.from_numpy((x / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2)


def _load_backbone(args):
    """The IR backbone of --arch on --device with --ckpt's weights, folded
    with --fold (or --quantize), int8 with --quantize int8."""
    import torch

    from jabd_tpu_torch import resolve_device
    from jabd_tpu_torch.recognition import build_model

    dev = resolve_device(args.device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(args.arch, device="cpu")
    if args.ckpt:
        if args.ckpt.endswith((".pth", ".tar", ".ckpt")):
            from jabd_tpu_torch.recognition.torch_convert import ir_state_dict_from_pth
            from jabd_tpu_torch.utils.torch_convert import load_pth

            state = ir_state_dict_from_pth(load_pth(args.ckpt), model.num_layers, model.mode)
        else:
            state = torch.load(args.ckpt, map_location="cpu", weights_only=True)
            state = state.get("model", state)
        model.load_state_dict(state)
    else:
        print("[warn] no --ckpt: random init", file=sys.stderr)
    quantize = getattr(args, "quantize", "none")
    if getattr(args, "fold", False) or quantize != "none":
        from jabd_tpu_torch.recognition.fold import fold_ir

        fold_ir(model)
    model = model.to(dev)
    if quantize == "int8":
        from jabd_tpu_torch.models import quantize as Q

        sample = calibration_faces().to(dev)
        calib = Q.calibrate(model, [sample])
        ratio = 1.0
        if getattr(args, "quantize_search", False):
            ratio, _ = Q.search_clip_ratio(model, calib, [sample])
            print(f"[int8] clip ratio {ratio}", file=sys.stderr)
        n = Q.quantize_model(model, calib, clip_ratio=ratio)
        print(f"[int8] quantized {n} conv sites", file=sys.stderr)
    return model


def _load_images(paths):
    """Image files -> [N, 112, 112, 3] RGB float32 in [-1, 1], each
    resized to 112 as cv2.resize (INTER_LINEAR) would."""
    import numpy as np

    from jabd_tpu_torch.eval.run_wider import decode_bgr
    from jabd_tpu_torch.recognition.data import normalize_face, resize_face

    out = np.zeros((len(paths), 112, 112, 3), np.float32)
    for i, p in enumerate(paths):
        try:
            img = decode_bgr(p)
        except (OSError, ValueError):
            raise SystemExit(f"error: cannot read image {p!r}")
        out[i] = normalize_face(resize_face(img)[:, :, ::-1])  # BGR -> RGB
    return out


def cmd_export(args):
    """The embedding graph as a serving artifact (aot.export_embedder),
    folded or int8 as the flags say."""
    import os

    from jabd_tpu_torch.aot import export_embedder

    model = _load_backbone(args)
    platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
    out = export_embedder(model, args.out, batch_size=args.batch_size, image_size=112,
                          platforms=platforms, model_name=args.arch)
    sizes = {n: os.path.getsize(os.path.join(out, n)) for n in sorted(os.listdir(out))}
    print(json.dumps({"out": out, "platforms": platforms, "bytes": sizes}))


def cmd_train(args):
    """AdaFace training over the ImageFolder at --data-root (recognition/
    train.fit): the backbone seeded with --seed under a forked torch RNG,
    the head's kernel from a generator seeded with it."""
    import torch

    from jabd_tpu_torch import resolve_device
    from jabd_tpu_torch.parallel import mesh as M
    from jabd_tpu_torch.recognition import build_head, build_model
    from jabd_tpu_torch.recognition import train as RT
    from jabd_tpu_torch.recognition.data import ImageFolderDataset

    # Flag validation before the model and state are built (the JAX CLI's exits).
    if args.fsdp and not args.shard_head:
        raise SystemExit(
            "--fsdp requires --shard-head (the FSDP placement rides the "
            "same sharded-step jit; plain DP stays replicated)"
        )
    if args.shard_head and args.microbatches > 1:
        raise SystemExit(
            "--microbatches with --shard-head is not supported: the "
            "class-sharded step is already the memory lever for the head, "
            "and chunk-scanning under the sharded program is untested"
        )
    dev = resolve_device(args.device)
    mesh = None
    if args.shard_head:
        # The process group torchrun describes (gloo for --device cpu); a no-op alone.
        M.init_distributed(backend="gloo" if (args.device or "").startswith("cpu") else None)
        mesh = M.process_mesh(dev)
    ds = ImageFolderDataset(args.data_root)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = build_model(args.arch, device="cpu")
    model = model.to(dev)
    pad_to = mesh.size if mesh is not None else 0
    head = build_head(args.head, class_num=ds.num_classes, m=args.m, pad_to=pad_to, seed=args.seed, device=dev)
    steps_per_epoch = max(len(ds) // args.batch_size, 1)
    state = RT.create_state(
        model, head, num_train_steps_hint=steps_per_epoch * args.epochs, lr=args.lr,
        milestones=tuple(m * steps_per_epoch for m in args.milestones),
    )
    compute_dtype = "bfloat16" if args.precision == 16 else "float32"
    if mesh is not None:
        from jabd_tpu_torch.recognition import parallel as RP

        maker = RP.make_sharded_train_step_aug if args.device_augment else RP.make_sharded_train_step
        step, state = maker(state, mesh, fsdp=args.fsdp, compute_dtype=compute_dtype, seed=args.seed)
        if mesh.rank == 0:
            print(f"[shard-head] {ds.num_classes} classes over {mesh.size} ranks"
                  + (" + fsdp backbone" if args.fsdp else ""), file=sys.stderr)
    else:
        maker = RT.make_train_step_aug if args.device_augment else RT.make_train_step
        step = maker(microbatches=args.microbatches, compute_dtype=compute_dtype, seed=args.seed)
    RT.fit(
        state, step, ds, args.batch_size, args.epochs, device_augment=args.device_augment, seed=args.seed,
        val_dir=args.val_dir, checkpoint_dir=args.checkpoint_dir, save_period=args.save_period,
        resume=not args.no_resume, device=dev, mesh=mesh,
    )


def cmd_verify(args):
    from jabd_tpu_torch.recognition import train as RT

    model = _load_backbone(args)
    print(json.dumps(RT.validate_5sets(model, args.data_dir, args.batch_size, device=args.device)))


def cmd_tinyface(args):
    """Flip-TTA features over the TinyFace protocol's images, then rank-1/5/20
    identification."""
    import numpy as np

    from jabd_tpu_torch.recognition import train as RT
    from jabd_tpu_torch.recognition.tinyface import TinyFaceTest

    model = _load_backbone(args)
    test = TinyFaceTest(args.tinyface_root, args.alignment_dir)
    images = _load_images(test.image_paths)
    faceness = None
    if args.faceness_scores:
        faceness = np.load(args.faceness_scores)
        if len(faceness) != len(test.image_paths):
            sys.exit("faceness scores must align with the protocol image list")
    feats, _ = RT.extract_embeddings_tta(
        model, images, batch_size=args.batch_size, fusion_method=args.fusion_method,
        use_flip_test=not args.no_flip_test, faceness_scores=faceness, device=args.device,
    )
    res = test.test_identification(feats, ranks=(1, 5, 20))
    print(json.dumps({f"rank_{k}": v for k, v in res.items()}))


def cmd_extract(args):
    """Partitioned features of an image list -> <out-dir>/features.npz
    (emb, norm, paths), resuming from its part files."""
    import numpy as np

    from jabd_tpu_torch.recognition import train as RT

    mesh = None
    if args.data_parallel:
        from jabd_tpu_torch.parallel.mesh import make_mesh_for_batch

        devices = [d.strip() for d in args.device.split(",")] if args.device else None
        mesh = make_mesh_for_batch(args.batch_size, devices)
        args.device = str(mesh.devices[0])
        if mesh.size > 1:
            print(f"[mesh] extraction sharded over {mesh.size} devices", file=sys.stderr)
    with open(args.image_list) as f:
        paths = [line.strip() for line in f if line.strip()]
    model = _load_backbone(args)
    emb, norms = RT.extract_features_partitioned(
        model, image_loader=lambda i: _load_images([paths[i]])[0], num_images=len(paths),
        num_partitions=args.partitions, batch_size=args.batch_size, save_dir=args.out_dir,
        mesh=mesh, device=args.device,
    )
    np.savez(f"{args.out_dir}/features.npz", emb=emb, norm=norms, paths=np.asarray(paths))
    print(f"extracted {len(paths)} features -> {args.out_dir}/features.npz")


def cmd_ijbs(args):
    """features.npz (from `extract`) and the cs6 protocol directory -> the
    five IJB-S protocols' metrics."""
    import numpy as np

    from jabd_tpu_torch.recognition.ijbs_proto import IJBSProtocol

    data = np.load(args.features, allow_pickle=True)
    emb, norm = data["emb"], data["norm"]
    paths = [str(p) for p in data["paths"]]
    proto = IJBSProtocol.from_protocol_dir(args.protocol_dir)
    proto.initialize_indices(paths)
    test = proto.build_test(emb, norm, fuse_match_method=args.fuse_match_method)
    out = {}
    for name, (closed, open_) in test.run_all().items():
        out[name] = {
            "rank1": float(closed[0]),
            "rank5": float(closed[1]),
            "rank10": float(closed[2]),
            "dir_far_0.01": float(open_[0]),
            "dir_far_0.1": float(open_[1]),
        }
    print(json.dumps(out, indent=2))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="jabd_tpu_torch.recognition")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default=None, help="torch device; the card unless given (e.g. cpu)")

    def model_args(sp):
        sp.add_argument("--arch", default="ir_50")
        sp.add_argument("--ckpt", default="")
        sp.add_argument("--batch-size", type=int, default=256)
        sp.add_argument("--fold", action="store_true", help="fold conv+BN pairs for the eval graph (exact)")
        sp.add_argument(
            "--quantize", choices=["none", "int8"], default="none",
            help="int8 convs and projection; activation scales self-calibrated on synthetic "
            "normalized inputs (calibrate on real samples through the API for production accuracy); "
            "on an H100 int8 ran slower than bf16 (PERF.md, section 6)",
        )
        sp.add_argument(
            "--quantize-search", action="store_true",
            help="with --quantize int8: grid-search a global activation clip ratio by end-to-end embedding error",
        )
        device(sp)

    sp = sub.add_parser("train", help="AdaFace training over a class-per-directory image folder")
    sp.add_argument("--data-root", required=True)
    sp.add_argument("--arch", default="ir_50")
    sp.add_argument("--head", default="adaface")
    sp.add_argument("--m", type=float, default=0.4)
    sp.add_argument("--lr", type=float, default=0.1)
    sp.add_argument("--batch-size", type=int, default=256)
    sp.add_argument("--epochs", type=int, default=26)
    sp.add_argument("--milestones", type=int, nargs="+", default=[12, 20, 24],
                    help="epochs at which the lr falls by 10x")
    sp.add_argument("--val-dir", default="", help="validation .bin sets or memfiles, checked after each epoch")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument(
        "--checkpoint-dir", default="",
        help="epoch checkpoints <dir>/<epoch>.pt (backbone, head, optimizer, step) with auto-resume from "
        "the latest; a best-on-val_acc copy under <dir>/best, best_meta.json and per-epoch metrics.csv",
    )
    sp.add_argument("--save-period", type=int, default=1)
    sp.add_argument("--no-resume", action="store_true", help="start fresh even if --checkpoint-dir has checkpoints")
    sp.add_argument("--device-augment", action="store_true",
                    help="run the augmentation on the card inside the step; the host only decodes")
    sp.add_argument("--shard-head", action="store_true",
                    help="shard the head along classes over the process group (torchrun; recognition/parallel.py)")
    sp.add_argument("--fsdp", action="store_true", help="with --shard-head: FSDP-shard the backbone")
    sp.add_argument("--microbatches", type=int, default=1,
                    help="split each batch into N chunks (ghost BatchNorm), average their gradients, one update")
    sp.add_argument("--precision", type=int, choices=(16, 32), default=32,
                    help="16 runs the backbone under bfloat16 autocast (parameters and the head stay float32)")
    device(sp)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("export", help="the embedding graph as a serving artifact (with --fold / --quantize int8)")
    model_args(sp)
    sp.add_argument("--out", required=True)
    sp.add_argument("--platforms", default="cuda",
                    help="the torch device type the artifact runs on: the device it is exported on")
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("verify")
    model_args(sp)
    sp.add_argument("--data-dir", required=True)
    sp.set_defaults(fn=cmd_verify)

    sp = sub.add_parser("tinyface")
    model_args(sp)
    sp.add_argument("--tinyface-root", required=True)
    sp.add_argument("--alignment-dir", default="aligned_pad_0.1_pad_high")
    sp.add_argument(
        "--fusion-method", default="pre_norm_vector_add",
        choices=("average", "norm_weighted_avg", "pre_norm_vector_add", "concat", "faceness_score"),
    )
    sp.add_argument("--no-flip-test", action="store_true")
    sp.add_argument("--faceness-scores", default="",
                    help=".npy of per-image detector scores aligned with the protocol image list "
                    "(required for faceness_score fusion)")
    sp.set_defaults(fn=cmd_tinyface)

    sp = sub.add_parser("extract")
    model_args(sp)
    sp.add_argument("--image-list", required=True)
    sp.add_argument("--out-dir", required=True)
    sp.add_argument("--partitions", type=int, default=100)
    sp.add_argument("--data-parallel", action="store_true",
                    help="split each batch over a replica per card (or per comma-separated --device entry)")
    sp.set_defaults(fn=cmd_extract)

    sp = sub.add_parser("ijbs")
    sp.add_argument("--features", required=True, help="features.npz from `extract` (emb, norm, paths)")
    sp.add_argument("--protocol-dir", required=True,
                    help="IJB-S cs6 protocol directory (cs6_metadata.csv, galleries/)")
    sp.add_argument("--fuse-match-method", default="pre_norm_vector_add_cos",
                    choices=("pre_norm_vector_add_cos", "mean_cos"))
    sp.set_defaults(fn=cmd_ijbs)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
