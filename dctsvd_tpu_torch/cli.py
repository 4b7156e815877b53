"""Command-line interface of the port (counterpart of
``dctsvd_tpu/cli.py``): ``embed``, ``extract``, ``detect``,
``embed-payload``, ``extract-payload`` and the four ``video-*``
subcommands with the JAX package's flags, plus ``--device`` (default
``cuda``).

    python -m dctsvd_tpu_torch.cli embed cover.png wm.png --out s.png \\
        --password pw                       # parity path (--method full)
    python -m dctsvd_tpu_torch.cli extract s.png s_meta.npz --out wm.png \\
        --password pw                       # with the enhancement chain
    python -m dctsvd_tpu_torch.cli detect s.png s_meta.npz
    python -m dctsvd_tpu_torch.cli embed-payload cover.png "text" \\
        --out p.png --password pw
    python -m dctsvd_tpu_torch.cli extract-payload p.png p_meta.npz \\
        --password pw
    python -m dctsvd_tpu_torch.cli video-embed clip.mp4 --watermark wm.png \\
        --out marked.mp4 [--color] [--scheme blocked] [--resume]
    python -m dctsvd_tpu_torch.cli video-extract marked.mp4 marked_meta.npz
    python -m dctsvd_tpu_torch.cli video-detect marked.mp4
    python -m dctsvd_tpu_torch.cli video-info clip.mp4

Global flags: ``--device``, ``--profile DIR`` (a ``torch.profiler`` Chrome
trace of the command, written into DIR) and ``--log-level``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from dctsvd_tpu_torch.utils.config import (ALPHA_GUI_DEFAULT,
                                           ALPHA_VIDEO_DEFAULT,
                                           FONT_SIZE_DEFAULT,
                                           FRAME_INTERVAL_DEFAULT,
                                           K_FRAC_DEFAULT)


def _default_meta(out_path: str) -> str:
    """<out base>_meta.npz next to the output."""
    return os.path.splitext(out_path)[0] + "_meta.npz"


def _add_common_embed(p):
    p.add_argument("--alpha", type=float, default=ALPHA_GUI_DEFAULT,
                   help="embedding strength (GUI default 0.12; "
                        "recommended 0.10-0.18 gray, 0.15-0.22 color)")
    p.add_argument("--kfrac", type=float, default=K_FRAC_DEFAULT)
    p.add_argument("--password", required=False)
    p.add_argument("--method", choices=["full", "blocked"], default="full",
                   help="full = parity whole-frame DCT+SVD; blocked = 8x8 "
                        "batched Jacobi")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="dctsvd-tpu-torch",
        description="DCT-SVD image/video watermarking on PyTorch + CUDA")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain twins)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of the "
                         "command into DIR")
    ap.add_argument("--log-level", default="INFO",
                    choices=["DEBUG", "INFO", "WARNING", "ERROR"])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("embed", help="embed an image watermark")
    p.add_argument("cover")
    p.add_argument("watermark")
    p.add_argument("--out", default="stego.png")
    p.add_argument("--meta", default=None)
    p.add_argument("--color", action="store_true",
                   help="per-BGR-channel embed instead of Y-channel")
    _add_common_embed(p)

    p = sub.add_parser("extract", help="extract the watermark (password)")
    p.add_argument("stego")
    p.add_argument("meta")
    p.add_argument("--out", default="wm.png")
    p.add_argument("--password", required=False, default=None,
                   help="required for password-protected metas; omit for "
                        "open-mode metas")
    p.add_argument("--no-normalize", action="store_true")
    p.add_argument("--no-enhance", action="store_true",
                   help="skip the NLM->CLAHE->unsharp chain")

    p = sub.add_parser("detect", help="no-password NC detection")
    p.add_argument("stego")
    p.add_argument("meta")
    p.add_argument("--thresh", type=float, default=None,
                   help="decision threshold (default: 0.6 for parity "
                        "metas, the ROC-backed 0.30 for blocked metas)")
    p.add_argument("--resync", action="store_true",
                   help="blocked metas: also search candidate translations "
                        "(one batched detect per chunk of 64 rolls)")
    p.add_argument("--resync-rot", type=float, default=0.0, metavar="DEG",
                   help="with --resync: also search attacker rotations "
                        "within +-DEG degrees")
    p.add_argument("--resync-rot-step", type=float, default=0.05,
                   metavar="DEG", help="angle grid resolution")

    p = sub.add_parser("embed-payload", help="embed a text/JSON payload")
    p.add_argument("cover")
    p.add_argument("payload", help="text, or @file.json for JSON")
    p.add_argument("--out", default="stego.png")
    p.add_argument("--meta", default=None)
    p.add_argument("--repeat", type=int, default=8)
    _add_common_embed(p)

    p = sub.add_parser("extract-payload", help="recover a text/JSON payload")
    p.add_argument("stego")
    p.add_argument("meta")
    p.add_argument("--password")

    p = sub.add_parser("video-embed", help="per-frame video embed")
    p.add_argument("host")
    p.add_argument("--watermark", help="watermark image path")
    p.add_argument("--text", help="text watermark instead of an image")
    p.add_argument("--out", default="marked.mp4")
    p.add_argument("--meta", default=None)
    p.add_argument("--alpha", type=float, default=ALPHA_VIDEO_DEFAULT)
    p.add_argument("--frame-interval", type=int,
                   default=FRAME_INTERVAL_DEFAULT)
    p.add_argument("--font-size", type=int, default=FONT_SIZE_DEFAULT)
    p.add_argument("--color", action="store_true")
    p.add_argument("--audio", action="store_true",
                   help="preserve audio via ffmpeg (graceful fallback); "
                        "implies the per-channel color embed")
    p.add_argument("--scheme", choices=["full", "blocked"], default="full",
                   help="full = whole-frame SVD (reference parity); "
                        "blocked = the 8x8 kernels")
    p.add_argument("--resume", action="store_true",
                   help="checkpointed segment writing; rerun with the same "
                        "args to continue an interrupted embed")

    p = sub.add_parser("video-extract", help="extract a video watermark")
    p.add_argument("video")
    p.add_argument("meta")
    p.add_argument("--out", default="wm.png")

    p = sub.add_parser("video-detect", help="blind statistical detect")
    p.add_argument("video")
    p.add_argument("--sample-rate", type=int, default=30)

    p = sub.add_parser("video-info", help="fps, size and frame count")
    p.add_argument("video")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from dctsvd_tpu_torch.utils import profiling
    profiling.setup_logging(getattr(logging, args.log_level))
    with profiling.trace(args.profile):
        return _run(args)


def _video_embed(args) -> int:
    from dctsvd_tpu_torch.models import video as m_video
    # exactly one watermark source: cv2.imread(None) deep in the frame
    # loop is an opaque crash, and silently preferring one of two given
    # watermarks embeds something the user did not ask for
    if bool(args.watermark) == bool(args.text):
        print("error: video-embed needs exactly one of --watermark "
              "or --text", file=sys.stderr)
        return 2
    meta = args.meta or _default_meta(args.out)
    kw = dict(alpha=args.alpha, frame_interval=args.frame_interval,
              scheme=args.scheme, resume=args.resume, device=args.device)
    text_kw = dict(font_size=args.font_size, **kw)
    if args.text and args.audio:
        res = m_video.embed_text_watermark_video_color_with_audio(
            args.host, args.text, args.out, meta, **text_kw)
    elif args.audio:
        res = m_video.embed_watermark_video_color_with_audio(
            args.host, args.watermark, args.out, meta, **kw)
    elif args.text and args.color:
        res = m_video.embed_text_watermark_video_color(
            args.host, args.text, args.out, meta, **text_kw)
    elif args.text:
        res = m_video.embed_text_watermark_video(
            args.host, args.text, args.out, meta, **text_kw)
    elif args.color:
        res = m_video.embed_watermark_video_color(
            args.host, args.watermark, args.out, meta, **kw)
    else:
        res = m_video.embed_watermark_video(
            args.host, args.watermark, args.out, meta, **kw)
    print(json.dumps({"video": res[0], "meta": res[1]}))
    return 0


def _run(args) -> int:
    if args.cmd == "video-embed":
        return _video_embed(args)
    if args.cmd == "video-extract":
        from dctsvd_tpu_torch.models import video as m_video
        text = m_video.extract_text_watermark_video(
            args.video, args.meta, args.out, device=args.device)
        print(json.dumps({"watermark": args.out, "text": text}))
        return 0
    if args.cmd == "video-detect":
        from dctsvd_tpu_torch.models import video as m_video
        stats = m_video.detect_watermark_video(
            args.video, frame_sample_rate=args.sample_rate,
            device=args.device)
        stats.pop("frame_statistics", None)
        print(json.dumps(stats))
        return 0
    if args.cmd == "video-info":
        from dctsvd_tpu_torch.io import video_io
        print(json.dumps(video_io.get_video_info(args.video)))
        return 0
    from dctsvd_tpu_torch import api
    if args.cmd == "embed":
        meta = args.meta or _default_meta(args.out)
        out, meta_p, ps, ss = api.embed(
            args.cover, args.watermark, args.out, meta, alpha=args.alpha,
            color=args.color, password=args.password, kfrac=args.kfrac,
            method=args.method, device=args.device)
        print(json.dumps({"stego": out, "meta": meta_p,
                          "psnr": round(ps, 2), "ssim": round(ss, 4)}))
    elif args.cmd == "extract":
        out = api.extract(args.stego, args.meta, args.out,
                          password=args.password,
                          normalize=not args.no_normalize,
                          enhance=not args.no_enhance, device=args.device)
        print(json.dumps({"watermark": out}))
    elif args.cmd == "detect":
        found, score = api.detect(args.stego, args.meta, thresh=args.thresh,
                                  resync=args.resync,
                                  rot_range=args.resync_rot,
                                  rot_step=args.resync_rot_step,
                                  device=args.device)
        print(json.dumps({"watermarked": found, "score": round(score, 4)}))
        return 0 if found else 1
    elif args.cmd == "embed-payload":
        payload = args.payload
        if payload.startswith("@"):
            with open(payload[1:]) as f:
                payload = json.load(f)
        meta = args.meta or _default_meta(args.out)
        out, meta_p, ps, _ = api.embed_payload(
            args.cover, payload, args.out, meta, alpha=args.alpha,
            password=args.password, kfrac=args.kfrac, repeat=args.repeat,
            method=args.method, device=args.device)
        print(json.dumps({"stego": out, "meta": meta_p,
                          "psnr": round(ps, 2)}))
    elif args.cmd == "extract-payload":
        got = api.extract_payload(args.stego, args.meta,
                                  password=args.password, device=args.device)
        print(json.dumps({"payload": got}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
