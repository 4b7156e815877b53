"""Command-line interface of the port (counterpart of
``dctsvd_tpu/cli.py``): ``embed``, ``extract``, ``detect``,
``embed-payload`` and ``extract-payload`` with the JAX package's flags,
plus ``--device`` (default ``cuda``).

    python -m dctsvd_tpu_torch.cli embed cover.png wm.png --out s.png \\
        --password pw                       # parity path (--method full)
    python -m dctsvd_tpu_torch.cli extract s.png s_meta.npz --out wm.png \\
        --password pw                       # with the enhancement chain
    python -m dctsvd_tpu_torch.cli detect s.png s_meta.npz
    python -m dctsvd_tpu_torch.cli embed-payload cover.png "text" \\
        --out p.png --password pw
    python -m dctsvd_tpu_torch.cli extract-payload p.png p_meta.npz \\
        --password pw

The video subcommands are not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from dctsvd_tpu_torch.utils.config import ALPHA_GUI_DEFAULT, K_FRAC_DEFAULT


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
        description="DCT-SVD image watermarking on PyTorch + CUDA")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain twins)")
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
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
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
