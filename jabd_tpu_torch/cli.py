"""Command-line interface of the PyTorch port.

Port of `jabd_tpu/cli.py`: the same subcommands, flags and defaults, over
the port's presets, on the card unless `--device cpu` is given.

  python -m jabd_tpu_torch.cli predict  --model jabd_flagship --image img.jpg
  python -m jabd_tpu_torch.cli dir-predict --model ... --input-dir d/ --out o/
  python -m jabd_tpu_torch.cli video    --model ... [--video path|camera index]
  python -m jabd_tpu_torch.cli fps      --model ... --image img.jpg
  python -m jabd_tpu_torch.cli count    --model jabd_flagship [--size 640]
  python -m jabd_tpu_torch.cli map-txt  --model ... --val-dir widerval/ --out p/
  python -m jabd_tpu_torch.cli eval     --pred-dir p/ --gt-dir gt/
  python -m jabd_tpu_torch.cli train    --model jabd_flagship --label-txt l.txt
  python -m jabd_tpu_torch.cli export   --model ... --out art/ --batch-size 8
  python -m jabd_tpu_torch.cli serve    --model ... | --exported art/ [--arch ir_50 --gallery g.npz]
  python -m jabd_tpu_torch.cli export-pth --model ... --out m.pth
  python -m jabd_tpu_torch.cli identify --image img.jpg --gallery-dir people/ [--gallery g.npz]

`--weights` takes a reference `.pth`/`.tar` (its names mapped by
utils/torch_convert.py), a `CheckpointManager` directory of `cli train`
(its newest `<step>.pt`) or one such file; without it the weights are a
seeded random init and a `[warn]` says so. Images are decoded with PIL as
`cv2.imread` decodes them and drawn with PIL.ImageDraw; only `video`
imports cv2 (for VideoCapture / VideoWriter), when it runs.

`identify` and `serve --arch` load their IR embedder as the recognition
CLI does (recognition/cli.py::_load_backbone). `--spatial`,
`--data-parallel` and `--fsdp` wait for the parallelism slice: each exits
with a message naming it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

PARALLEL = "the parallelism slice"
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _not_yet(what: str, slice_name: str):
    sys.exit(f"the PyTorch port does not have yet: {what}: {slice_name}")


def _get_config(name):
    from jabd_tpu_torch import configs

    try:
        return configs.get_model_config(name)
    except KeyError as e:
        sys.exit(str(e.args[0]) if e.args else str(e))


def _load_state_dict(args, mcfg):
    """The port's (unfolded) state dict from --weights: a reference .pth /
    .tar, a CheckpointManager directory or `<step>.pt`, or a seeded random
    init (torch.Generator seeded 0, the reference's normal(0, 0.02))."""
    import torch

    from jabd_tpu_torch.models import build_model
    from jabd_tpu_torch.models.init import reference_weights_init

    path = getattr(args, "weights", "")
    if path.endswith((".pth", ".tar")):
        from jabd_tpu_torch.utils.torch_convert import convert_state_dict_auto, load_pth

        return convert_state_dict_auto(load_pth(path), mcfg)
    if path:
        if os.path.isdir(path):
            from jabd_tpu_torch.utils.checkpoint import CheckpointManager

            mgr = CheckpointManager(path)
            step = mgr.latest_step()
            if step is None:
                sys.exit(f"error: no <step>.pt checkpoint in {path!r}")
            path = mgr._path(step)
        return torch.load(path, map_location="cpu", weights_only=True)["model"]
    print("[warn] no --weights: random init", file=sys.stderr)
    model = build_model(mcfg, mode="eval", device="cpu")
    reference_weights_init(model, torch.Generator().manual_seed(0), "normal")
    return model.state_dict()


def _check_parallel_flags(args):
    for flag in ("spatial", "data_parallel"):
        if getattr(args, flag, False):
            _not_yet("--" + flag.replace("_", "-"), PARALLEL)


def _load_predictor(args):
    from jabd_tpu_torch import configs
    from jabd_tpu_torch.predict import Predictor

    mcfg = _get_config(args.model)
    state = _load_state_dict(args, mcfg)
    pcfg = configs.PredictConfig(
        confidence=args.confidence,
        nms_iou=args.nms_iou,
        input_shape=(args.input_size, args.input_size),
    )
    return Predictor(mcfg, state, pcfg, device=args.device)


def _draw(image, dets):
    """A BGR copy of `image` with each detection's box (red), five
    landmarks (green) and score drawn with PIL.ImageDraw."""
    import numpy as np
    from PIL import Image, ImageDraw

    canvas = Image.fromarray(np.ascontiguousarray(image[:, :, ::-1]))
    draw = ImageDraw.Draw(canvas)
    for d in dets:
        x1, y1, x2, y2 = (int(v) for v in d[:4])
        draw.rectangle((x1, y1, x2, y2), outline=(255, 0, 0), width=2)
        draw.text((x1, max(y1 - 11, 0)), f"{d[4]:.2f}", fill=(255, 255, 255))
        for p in range(5):
            cx, cy = int(d[5 + 2 * p]), int(d[6 + 2 * p])
            draw.ellipse((cx - 1, cy - 1, cx + 1, cy + 1), fill=(0, 255, 0))
    return np.asarray(canvas)[:, :, ::-1].copy()


def _imread(path):
    from jabd_tpu_torch.eval.run_wider import decode_bgr

    try:
        return decode_bgr(path)
    except (OSError, ValueError):
        sys.exit(f"error: cannot read image {path!r}")


def _imwrite(path, bgr):
    from PIL import Image

    Image.fromarray(bgr[:, :, ::-1].copy()).save(path)


def _list_images(directory, limit=None):
    paths = [
        os.path.join(directory, n)
        for n in sorted(os.listdir(directory))
        if n.lower().endswith(IMAGE_EXTS)
    ]
    return paths[:limit] if limit else paths


def _maybe_quantize(pred, samples, args):
    """Apply --quantize int8 to a live predictor, calibrating on
    `samples`. No-op unless requested."""
    if getattr(args, "quantize", "none") != "int8":
        return
    n = pred.quantize_int8(samples, search_clip=getattr(args, "quantize_search", False))
    print(f"[int8] quantized {n} conv sites", file=sys.stderr)


def cmd_export(args):
    """Export the detect graph with its weights to an artifact directory
    (aot.py), for the device it runs on."""
    from jabd_tpu_torch.aot import export_detector

    pred = _load_predictor(args)
    if args.quantize == "int8":
        if not args.calib_images:
            sys.exit(
                "--quantize int8 export needs --calib-images <dir> (a few "
                "representative images to calibrate activation scales)"
            )
        from jabd_tpu_torch.eval.run_wider import decode_bgr

        paths = _list_images(args.calib_images, limit=16)
        if not paths:
            sys.exit(f"no images in {args.calib_images!r}")
        _maybe_quantize(pred, [decode_bgr(p) for p in paths], args)
    platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
    out = export_detector(pred, args.out, batch_size=args.batch_size, platforms=platforms, model_name=args.model)
    sizes = {n: os.path.getsize(os.path.join(out, n)) for n in sorted(os.listdir(out))}
    print(json.dumps({"out": out, "platforms": platforms, "bytes": sizes}))


def cmd_export_pth(args):
    """Export the weights under the reference's own names to a .pth
    (utils/torch_convert.py), loadable into the reference's modules."""
    from jabd_tpu_torch.utils.torch_convert import export_state_dict_auto, save_pth

    mcfg = _get_config(args.model)
    sd = export_state_dict_auto(_load_state_dict(args, mcfg), mcfg)
    save_pth(sd, args.out)
    print(json.dumps({"out": args.out, "keys": len(sd)}))


def _load_embedder(args, quantize="none"):
    """The IR backbone of --arch / --ckpt, folded when --ckpt gives real
    weights (recognition/cli.py::_load_backbone)."""
    from jabd_tpu_torch.recognition.cli import _load_backbone

    return _load_backbone(argparse.Namespace(
        arch=args.arch, ckpt=args.ckpt, fold=bool(args.ckpt), quantize=quantize,
        quantize_search=False, device=args.device,
    ))


def cmd_serve(args):
    """HTTP daemon with dynamic batching (serve.py) over a live Predictor
    or an artifact (--exported); --arch adds POST /identify."""
    from jabd_tpu_torch.serve import BatchingDetector, IdentityService, serve

    if args.quantize == "int8":
        sys.exit(
            "--quantize int8 is not wired for `serve`: export an int8 "
            "artifact first (cli export --quantize int8 --calib-images "
            "dir/) and start `serve --exported <dir>`"
        )
    if args.exported:
        from jabd_tpu_torch.aot import load_exported

        backend = load_exported(args.exported, device=args.device)
    else:
        backend = _load_predictor(args)
    det = BatchingDetector(backend, batch_size=args.batch_size, max_wait_ms=args.max_wait_ms)
    identity = None
    if args.arch:
        from jabd_tpu_torch.pipeline import FacePipeline, Gallery

        gallery = Gallery.load(args.gallery) if args.gallery else None
        identity = IdentityService(
            FacePipeline(None, _load_embedder(args), device=args.device), gallery=gallery, threshold=args.threshold
        )
        print(f"[identify] {args.arch} embedder" + (f", gallery of {len(gallery.names)}" if gallery else ""),
              file=sys.stderr)
    serve(det, host=args.host, port=args.port, identity=identity)


def cmd_predict(args):
    img = _imread(args.image)
    if args.exported:
        from jabd_tpu_torch.aot import load_exported

        dets = load_exported(args.exported, device=args.device).detect_image(img)
        print(f"{len(dets)} faces (AOT artifact)")
    else:
        pred = _load_predictor(args)
        _maybe_quantize(pred, img[None], args)
        dets = pred.detect_image(img)
        print(f"{len(dets)} faces")
    out = args.out or "out_" + os.path.basename(args.image)
    _imwrite(out, _draw(img, dets))
    print("wrote", out)


def cmd_dir_predict(args):
    """Every image of a directory, drawn into --out. --batch-size > 1 runs
    `Predictor.detect_images` (mixed sizes letterboxed on the device), the
    tail chunk padded to the batch size; the next chunk decodes on a
    thread while the device runs the current one."""
    import concurrent.futures as cf

    from jabd_tpu_torch.eval.run_wider import decode_bgr

    pred = _load_predictor(args)
    os.makedirs(args.out, exist_ok=True)
    names = [os.path.basename(p) for p in _list_images(args.input_dir)]
    bs = max(args.batch_size, 1)

    def decode_chunk(lo):
        chunk_names, chunk = [], []
        for name in names[lo : lo + bs]:
            try:
                img = decode_bgr(os.path.join(args.input_dir, name))
            except (OSError, ValueError):
                print(f"[skip] unreadable image {name}")
                continue
            chunk_names.append(name)
            chunk.append(img)
        return chunk_names, chunk

    quantize = args.quantize == "int8"
    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(decode_chunk, 0) if names else None
        for i in range(0, len(names), bs):
            chunk_names, chunk = pending.result()
            pending = pool.submit(decode_chunk, i + bs) if i + bs < len(names) else None
            if not chunk:
                continue
            if quantize:  # calibrate on the first chunk
                _maybe_quantize(pred, chunk, args)
                quantize = False
            if bs == 1:
                dets_list = [pred.detect_image(chunk[0])]
            else:
                n = len(chunk)
                dets_list = pred.detect_images(chunk + [chunk[-1]] * (bs - n))[:n]
            for name, img, dets in zip(chunk_names, chunk, dets_list):
                _imwrite(os.path.join(args.out, name), _draw(img, dets))
                print(name, len(dets))


def _draw_names(image, dets, matches):
    """`_draw(image, dets)` with each face's gallery name (or '?') and
    cosine under its box, in yellow."""
    import numpy as np
    from PIL import Image, ImageDraw

    canvas = Image.fromarray(np.ascontiguousarray(_draw(image, dets)[:, :, ::-1]))
    draw = ImageDraw.Draw(canvas)
    for d, (name, sim) in zip(dets, matches):
        y = min(int(d[3]) + 3, image.shape[0] - 12)
        draw.text((int(d[0]), max(y, 0)), f"{name or '?'} {sim:.2f}", fill=(255, 255, 0))
    return np.asarray(canvas)[:, :, ::-1].copy()


def cmd_identify(args):
    """Detect -> align -> embed -> match against a named gallery
    (pipeline.py)."""
    if args.quantize == "int8":
        sys.exit(
            "--quantize int8 is not wired for `identify` (the detection "
            "predictor stays bf16 here); use --embed-quantize for the "
            "embedder or run detection via predict/dir-predict"
        )
    from jabd_tpu_torch.pipeline import FacePipeline, Gallery, enroll_directory

    pipe = FacePipeline(_load_predictor(args), _load_embedder(args, args.embed_quantize), device=args.device)
    if args.gallery and os.path.exists(args.gallery):
        gallery = Gallery.load(args.gallery)
        print(f"[gallery] loaded {len(gallery.names)} identities", file=sys.stderr)
    elif args.gallery_dir:
        gallery = enroll_directory(pipe, args.gallery_dir)
        print(f"[gallery] enrolled {len(gallery.names)} identities", file=sys.stderr)
        if args.gallery:
            gallery.save(args.gallery)
            print(f"[gallery] saved -> {args.gallery}", file=sys.stderr)
    else:
        sys.exit("error: need --gallery-dir or an existing --gallery")

    img = _imread(args.image)
    dets, embs = pipe.analyze(img)
    matches = gallery.match(embs, threshold=args.threshold)
    for d, (name, sim) in zip(dets, matches):
        print(json.dumps({
            "box": [round(float(v), 1) for v in d[:4]],
            "score": round(float(d[4]), 4),
            "name": name,
            "cosine": round(sim, 4),
        }))
    if args.out:
        _imwrite(args.out, _draw_names(img, dets, matches))
        print("wrote", args.out)


def cmd_video(args):
    """Every frame of a video file or camera through detect_image, drawn,
    with an EMA fps overlay (reference predict.py:478-520); writes --out
    (MJPG for .avi, mp4v otherwise) or prints a line every 25 frames."""
    import cv2

    pred = _load_predictor(args)
    src = int(args.video) if args.video.isdigit() else args.video
    cap = cv2.VideoCapture(src)
    writer = None
    fps = 0.0
    n_frames = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if n_frames == 0:
                _maybe_quantize(pred, frame[None], args)
            t0 = time.perf_counter()
            dets = pred.detect_image(frame)
            fps = 0.9 * fps + 0.1 / max(time.perf_counter() - t0, 1e-6)
            frame = _draw(frame, dets)
            cv2.putText(frame, f"fps {fps:.1f}", (8, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 255, 0), 2)
            if args.out:
                if writer is None:
                    fourcc = "MJPG" if args.out.lower().endswith(".avi") else "mp4v"
                    writer = cv2.VideoWriter(
                        args.out, cv2.VideoWriter_fourcc(*fourcc), 25, (frame.shape[1], frame.shape[0])
                    )
                writer.write(frame)
            elif n_frames % 25 == 0:
                print(f"frame {n_frames}: {len(dets)} faces, fps {fps:.1f}", flush=True)
            n_frames += 1
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    print(f"processed {n_frames} frames")


def cmd_fps(args):
    pred = _load_predictor(args)
    img = _imread(args.image)
    _maybe_quantize(pred, img[None], args)
    fps = pred.get_fps(img, test_interval=args.iters, method=args.method)
    print(json.dumps({"fps": fps, "method": args.method, "input": args.input_size}))


def cmd_count(args):
    """Parameters and convolution/matmul GFLOPs of one forward at
    --size (utils/profiling.py); --per-layer adds a row per top-level
    module. The reference's count_param.py."""
    import torch

    from jabd_tpu_torch.models import build_model
    from jabd_tpu_torch.utils.profiling import count_params, flops_of, per_layer_table

    mcfg = _get_config(args.model)
    model = build_model(mcfg, mode="eval", device=args.device).eval()
    x = torch.zeros((1, 3, args.size, args.size), device=next(model.parameters()).device)
    n = count_params(model)
    fl = flops_of(model, x)
    out = {"model": args.model, "params_m": round(n / 1e6, 4), "params": n, "gflops": round(fl / 1e9, 4), "input": args.size}
    if args.per_layer:
        rows = per_layer_table(model, x, total_params=n, total_flops=fl)
        out["per_layer"] = rows
        w = max(len(r["module"]) for r in rows) + 2
        print(f"{'module'.ljust(w)}{'params':>12}  {'gflops':>10}")
        for r in rows:
            print(f"{r['module'].ljust(w)}{r['params']:>12,}  {r['gflops']:>10.4f}")
    print(json.dumps(out))


def _val_samples(val_dir, limit=8):
    from jabd_tpu_torch.eval.run_wider import decode_bgr

    sample = []
    for event in sorted(os.listdir(val_dir)):
        event_dir = os.path.join(val_dir, event)
        if not os.path.isdir(event_dir):
            continue
        for name in sorted(os.listdir(event_dir)):
            if name.lower().endswith((".jpg", ".png")) and len(sample) < limit:
                try:
                    sample.append(decode_bgr(os.path.join(event_dir, name)))
                except (OSError, ValueError):
                    pass
    return sample


def _quantize_for_map_txt(args, pred):
    """int8-quantize before a map-txt sweep, calibrating on the val tree's
    first 8 images. With --quantize-search and --gt-dir each clip ratio is
    scored by the mean easy/medium/hard WIDER AP of a full sweep."""
    sample = _val_samples(args.val_dir)
    if not sample:
        raise SystemExit("--quantize int8: no readable val images")
    score_fn = None
    if args.quantize_search and args.gt_dir:
        from jabd_tpu_torch.eval import evaluate_wider
        from jabd_tpu_torch.eval.run_wider import run_wider_val

        def score_fn(qmodel):
            saved = pred.model
            pred.model = qmodel
            try:
                preds = run_wider_val(pred, args.val_dir, batch_size=max(args.batch_size, 1))
                aps = evaluate_wider(preds, args.gt_dir)
                score = -(aps["easy"] + aps["medium"] + aps["hard"]) / 3.0
                print(f"[int8 search] mean AP {-score:.4f}", file=sys.stderr)
                return score
            finally:
                pred.model = saved

    n = pred.quantize_int8(sample, search_clip=args.quantize_search, score_fn=score_fn)
    print(f"[int8] quantized {n} conv sites", file=sys.stderr)


def cmd_map_txt(args):
    """The reference's txt dumps of a WIDER val tree (predict.py:338-415
    format). --batch-size > 1 or --multiscale run the batched sweep
    (eval/run_wider.py); otherwise one image at a time."""
    from jabd_tpu_torch.eval.run_wider import decode_bgr

    pred = _load_predictor(args)
    if args.quantize == "int8":
        _quantize_for_map_txt(args, pred)
    if args.batch_size > 1 or args.multiscale:
        from jabd_tpu_torch.eval.run_wider import run_wider_val

        run_wider_val(
            pred, args.val_dir, batch_size=args.batch_size, out_dir=args.out,
            multiscale=args.multiscale, pyramid=args.pyramid,
        )
        return
    for event in sorted(os.listdir(args.val_dir)):
        event_dir = os.path.join(args.val_dir, event)
        if not os.path.isdir(event_dir):
            continue
        out_event = os.path.join(args.out, event)
        os.makedirs(out_event, exist_ok=True)
        for name in sorted(os.listdir(event_dir)):
            if not name.lower().endswith((".jpg", ".png")):
                continue
            try:
                img = decode_bgr(os.path.join(event_dir, name))
            except (OSError, ValueError):
                print("skipping unreadable", name, file=sys.stderr)
                continue
            rows = pred.get_map_txt_rows(img)
            stem = os.path.splitext(name)[0]
            with open(os.path.join(out_event, stem + ".txt"), "w") as f:
                f.write(f"{event}/{name}\n{len(rows)}\n")
                for r in rows:
                    f.write(f"{r[0]:.3f} {r[1]:.3f} {r[2]:.3f} {r[3]:.3f} {r[4]:.5f}\n")
        print("event done:", event)


def cmd_eval(args):
    from jabd_tpu_torch.eval import evaluate_wider

    aps = evaluate_wider(args.pred_dir, args.gt_dir, iou_thresh=args.iou)
    print(json.dumps({k: round(v, 5) for k, v in aps.items()}))


def cmd_train(args):
    from jabd_tpu_torch import configs, train
    from jabd_tpu_torch.data.wider import WiderFaceDataset
    from jabd_tpu_torch.utils.checkpoint import CheckpointManager

    if args.fsdp:
        _not_yet("--fsdp", PARALLEL)
    mcfg = _get_config(args.model)
    tcfg = configs.TrainConfig(
        batch_size=args.batch_size,
        image_size=args.input_size,
        total_epochs=args.epochs,
        freeze_epochs=args.freeze_epochs,
        device_augment=args.device_augment,
        save_period=args.save_period,
        microbatches=args.microbatches,
        matching_impl=args.matching_impl,
    )
    ds = WiderFaceDataset(args.label_txt, input_size=tcfg.image_size)
    mgr = CheckpointManager(args.ckpt_dir)
    train.fit(mcfg, tcfg, ds, log_dir=args.log_dir, checkpoint_manager=mgr, device=args.device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="jabd_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default=None, help="torch device; the card unless given (e.g. cpu)")

    def common(sp, weights=True):
        sp.add_argument("--model", default="jabd_flagship")
        if weights:
            sp.add_argument("--weights", default="")
        sp.add_argument("--confidence", type=float, default=0.5)
        # 0.3 = the reference's effective threshold: its declared
        # "nms_iou": 0.45 is dead (call sites pass only confidence,
        # predict.py:181; default 0.3 at utils_bbox.py:260).
        sp.add_argument("--nms-iou", type=float, default=0.3)
        sp.add_argument("--input-size", type=int, default=1280)
        sp.add_argument(
            "--quantize", choices=["none", "int8"], default="none",
            help="int8: per-channel int8 convs, activation scales calibrated on the first input",
        )
        sp.add_argument(
            "--quantize-search", action="store_true",
            help="with --quantize int8: grid-search a global activation clip ratio "
            "by end-to-end output error on the calibration images",
        )
        sp.add_argument("--spatial", action="store_true", help=f"spatial partitioning over cards ({PARALLEL})")
        device(sp)

    sp = sub.add_parser("predict")
    common(sp)
    sp.add_argument("--image", required=True)
    sp.add_argument("--out", default="")
    sp.add_argument("--exported", default="", help="run an artifact dir (cli export) instead of building the model")
    sp.set_defaults(fn=cmd_predict)

    sp = sub.add_parser("export", help="export the detect graph with its weights to an artifact dir")
    common(sp)
    sp.add_argument("--out", required=True)
    sp.add_argument("--batch-size", type=int, default=1)
    sp.add_argument(
        "--platforms", default="cuda",
        help="the torch device type the artifact runs on: the device it is exported on",
    )
    sp.add_argument(
        "--calib-images", default="",
        help="with --quantize int8: directory of images to calibrate activation scales",
    )
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("serve", help="HTTP serving daemon with dynamic batching (POST /detect, GET /healthz)")
    common(sp)
    sp.add_argument("--exported", default="", help="serve an artifact dir")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8712)
    sp.add_argument("--batch-size", type=int, default=8)
    sp.add_argument(
        "--max-wait-ms", type=float, default=15.0,
        help="max time to wait for batch-mates after the first request",
    )
    sp.add_argument("--data-parallel", action="store_true", help=f"shard batches over cards ({PARALLEL})")
    sp.add_argument(
        "--arch", default="",
        help="IR embedder arch (e.g. ir_50): enables POST /identify (detect -> align -> embed -> name)",
    )
    sp.add_argument("--ckpt", default="", help="embedder weights")
    sp.add_argument("--gallery", default="", help="gallery npz from `cli identify --gallery` for naming")
    sp.add_argument("--threshold", type=float, default=0.3)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("export-pth", help="export weights to a reference-named torch .pth state dict")
    common(sp)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_export_pth)

    sp = sub.add_parser("dir-predict")
    common(sp)
    sp.add_argument("--input-dir", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument(
        "--batch-size", type=int, default=1,
        help=">1 batches mixed-size images through one detect graph (letterbox on the device)",
    )
    sp.add_argument("--data-parallel", action="store_true", help=f"shard batches over cards ({PARALLEL})")
    sp.set_defaults(fn=cmd_dir_predict)

    sp = sub.add_parser(
        "identify",
        help="detect faces, align on the 5-point landmarks, embed with an IR backbone, and name them "
        "against a gallery (--gallery-dir tree of <name>/*.jpg, or a saved --gallery npz)",
    )
    common(sp)
    sp.add_argument("--image", required=True)
    sp.add_argument("--gallery-dir", default="")
    sp.add_argument("--gallery", default="", help="gallery npz: loaded if it exists, else written after enrolling --gallery-dir")
    sp.add_argument("--arch", default="ir_50")
    sp.add_argument("--ckpt", default="", help="embedder weights (AdaFace .pth/.ckpt or a port state dict)")
    sp.add_argument("--threshold", type=float, default=0.3)
    sp.add_argument(
        "--embed-quantize", choices=["none", "int8"], default="none",
        help="int8 embedder, calibrated on seeded noise, while detection keeps its preset's dtype. "
        "On an H100 80GB HBM3 at 700 W it lost accuracy (cosine 0.888 to float32) and ran 6.3x "
        "slower than bf16 at batch 256 (PERF.md, section 6)",
    )
    sp.add_argument("--out", default="")
    sp.set_defaults(fn=cmd_identify)

    sp = sub.add_parser("video")
    common(sp)
    sp.add_argument("--video", default="0")
    sp.add_argument("--out", default="")
    sp.set_defaults(fn=cmd_video)

    sp = sub.add_parser("fps")
    common(sp)
    sp.add_argument("--image", required=True)
    sp.add_argument("--iters", type=int, default=100)
    sp.add_argument(
        "--method", choices=["chained", "wall"], default="chained",
        help="'chained': CUDA events around back-to-back batches; 'wall': the host "
        "clock around the synchronized loop (the reference's harness, predict.py:253-333)",
    )
    sp.set_defaults(fn=cmd_fps)

    sp = sub.add_parser("count")
    sp.add_argument("--model", default="jabd_flagship")
    sp.add_argument("--size", type=int, default=640)
    sp.add_argument(
        "--per-layer", action="store_true",
        help="also print a per-module params/GFLOPs table (count_param.py:388-395)",
    )
    device(sp)
    sp.set_defaults(fn=cmd_count)

    sp = sub.add_parser("map-txt")
    common(sp)
    sp.add_argument("--val-dir", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--batch-size", type=int, default=1, help=">1 runs the batched val sweep")
    sp.add_argument("--data-parallel", action="store_true", help=f"shard batches over cards ({PARALLEL})")
    sp.add_argument("--multiscale", action="store_true", help="bicubic image-pyramid eval")
    sp.add_argument(
        "--pyramid", choices=("device", "host"), default="host",
        help="multiscale pre-scale on the host (cv2's recipe) or as composed plans on the device",
    )
    sp.add_argument(
        "--gt-dir", default="",
        help="with --quantize int8 --quantize-search: score clip ratios by WIDER AP "
        "against this GT tree (one sweep per grid point)",
    )
    sp.set_defaults(fn=cmd_map_txt)

    sp = sub.add_parser("eval")
    sp.add_argument("--pred-dir", required=True)
    sp.add_argument("--gt-dir", required=True)
    sp.add_argument("--iou", type=float, default=0.4)
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("train")
    sp.add_argument("--model", default="jabd_flagship")
    sp.add_argument("--label-txt", required=True)
    sp.add_argument("--batch-size", type=int, default=34)
    sp.add_argument("--input-size", type=int, default=840)
    sp.add_argument("--epochs", type=int, default=100)
    sp.add_argument("--freeze-epochs", type=int, default=50)
    sp.add_argument("--save-period", type=int, default=5)
    sp.add_argument("--ckpt-dir", default="checkpoints")
    sp.add_argument("--log-dir", default="logs")
    sp.add_argument(
        "--microbatches", type=int, default=1,
        help="split each batch into N ghost-BN microbatches with one optimizer update",
    )
    sp.add_argument("--device-augment", action="store_true", help="run the augmentation on the device")
    sp.add_argument(
        "--matching-impl", choices=["auto", "plain", "cuda"], default="auto",
        help="anchor matching: 'auto' = the CUDA kernel on the card, the plain version on the CPU",
    )
    sp.add_argument("--fsdp", action="store_true", help=f"shard parameters and Adam moments ({PARALLEL})")
    device(sp)
    sp.set_defaults(fn=cmd_train)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    _check_parallel_flags(args)
    args.fn(args)


if __name__ == "__main__":
    main()
