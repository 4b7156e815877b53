"""Optional desktop GUI — three tabs (EMBED / EXTRACT / DETECT), the
counterpart of ``dctsvd_tpu/gui.py`` over ``dctsvd_tpu_torch.api``: alpha
slider 0.01–0.30 synced with a spinbox (default 0.12), auto-filled
``<base>_stego.png`` / ``<base>_stego_meta.npz`` / ``<base>_wm.png``
output paths when a cover is chosen, password fields, an error label per
tab, and image preview panes for the host image on pick and the
extracted watermark after extract.

The three tab actions are pure module-level handlers
(:func:`handle_embed` / :func:`handle_extract` / :func:`handle_detect` —
plain args in, :class:`HandlerResult` out, no tkinter anywhere), so their
logic, including the password guard, is testable headlessly; the tk
layer in :func:`build_ui` / :func:`main` is a thin shell that binds
widgets to them and is the only place that imports tkinter. The handlers
run on ``device`` (the card by default, ``api.DEFAULT_DEVICE``); an
exception, a device error included, becomes an ``"ERROR: ..."`` result
with ``ok`` False.
"""

from __future__ import annotations

import os
import traceback
from typing import NamedTuple, Optional

from dctsvd_tpu_torch import api


class HandlerResult(NamedTuple):
    """Outcome of a GUI action: ``message`` goes to the tab's info label,
    ``preview_path`` (if set) is an image the shell should display."""
    ok: bool
    message: str
    preview_path: Optional[str] = None


def default_paths(cover_path: str):
    """Auto-filled output paths when a host image is chosen
    (ref: app_dct_svd_single.py:339-346): (stego, meta, extracted-wm)."""
    base = os.path.splitext(cover_path)[0]
    return (base + "_stego.png", base + "_stego_meta.npz",
            base + "_wm.png")


def handle_embed(cover: str, wm: str, out: str, password: str,
                 alpha: float, color: bool, blocked: bool,
                 device=api.DEFAULT_DEVICE) -> HandlerResult:
    """EMBED action. Refuses an empty password like the reference app
    (ref: app_dct_svd_single.py:115-116) — the password-less open mode is
    available via the library API / CLI only, never as a GUI default."""
    if not password:
        return HandlerResult(False, "ERROR: password required (the open, "
                             "password-less mode is available via the "
                             "library API / CLI only).")
    if not cover or not wm:
        return HandlerResult(False, "ERROR: choose a host image and a "
                             "watermark first.")
    # the spinbox advertises 0.01-0.30 but ttk does not clamp TYPED text:
    # alpha=0 embeds nothing behind a success message, alpha>>0.3 wrecks
    # the host — validate here (same bounds the scale advertises) so the
    # pure handler owns the contract
    if not (0.01 <= float(alpha) <= 0.30):
        return HandlerResult(False, f"ERROR: alpha {alpha} out of range "
                             "(use 0.01-0.30).")
    try:
        outp = out or "stego.png"
        meta = os.path.splitext(outp)[0] + "_meta.npz"
        out_p, meta_p, ps, ss = api.embed(
            cover, wm, outp, meta, alpha=float(alpha), color=color,
            password=password, method="blocked" if blocked else "full",
            device=device)
        return HandlerResult(True, f"Saved: {out_p}\nMeta: {meta_p}\n"
                             f"PSNR: {ps:.2f}  SSIM: {ss:.4f}",
                             preview_path=out_p)
    except Exception as e:
        traceback.print_exc()
        return HandlerResult(False, "ERROR: " + str(e))


def handle_extract(stego: str, meta: str, out: str,
                   password: str, device=api.DEFAULT_DEVICE) -> HandlerResult:
    """EXTRACT action; the recovered watermark path doubles as the
    preview."""
    if not stego or not meta:
        return HandlerResult(False, "ERROR: choose a stego image and its "
                             "meta (.npz) first.")
    try:
        out_p = api.extract(stego, meta, out or "wm.png",
                            password=password or None, device=device)
        return HandlerResult(True, f"Extracted watermark: {out_p}",
                             preview_path=out_p)
    except Exception as e:
        return HandlerResult(False, "ERROR: " + str(e))


def handle_detect(stego: str, meta: str,
                  device=api.DEFAULT_DEVICE) -> HandlerResult:
    """DETECT action (no password)."""
    if not stego or not meta:
        return HandlerResult(False, "ERROR: choose a stego image and its "
                             "meta (.npz) first.")
    try:
        ok, score = api.detect(stego, meta, device=device)
        return HandlerResult(True, f"Score: {score:.4f} -> "
                             f"{'Watermarked' if ok else 'Not found'}")
    except Exception as e:
        return HandlerResult(False, "ERROR: " + str(e))


def preview_ppm_bytes(image_path: str, max_side: int = 220) -> bytes:
    """Binary P6 PPM thumbnail of an image file — the format
    ``tk.PhotoImage(data=...)`` accepts on every Tk build, so previews
    need no extra dependency. Pure bytes out: testable without a display."""
    import cv2
    import numpy as np
    img = cv2.imread(image_path, cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f"Cannot open image: {image_path}")
    h, w = img.shape[:2]
    scale = min(1.0, max_side / max(h, w))
    if scale < 1.0:
        img = cv2.resize(img, (max(1, int(w * scale)),
                               max(1, int(h * scale))),
                         interpolation=cv2.INTER_AREA)
    rgb = np.ascontiguousarray(img[..., ::-1])      # BGR -> RGB
    header = f"P6 {rgb.shape[1]} {rgb.shape[0]} 255\n".encode()
    return header + rgb.tobytes()


def build_ui(root, device=api.DEFAULT_DEVICE):
    """Construct the notebook UI on an existing Tk root and return the
    widget-shell handle: the tab actions and their tk variables, so a
    display-gated smoke test can drive the real widget wiring (set vars,
    invoke the button commands, read the info labels) without a user.
    The actions run on ``device``."""
    import tkinter as tk
    from tkinter import filedialog, ttk

    root.title("DCT-SVD Watermarking (GPU)")
    nb = ttk.Notebook(root)
    nb.pack(fill="both", expand=True, padx=8, pady=8)
    photo_refs = {}          # keep PhotoImage objects alive per pane

    def file_row(parent, label, var, save=False, filetypes=None):
        row = ttk.Frame(parent)
        row.pack(fill="x", pady=2)
        ttk.Label(row, text=label, width=14).pack(side="left")
        ttk.Entry(row, textvariable=var).pack(side="left", fill="x",
                                              expand=True)

        def browse():
            fn = (filedialog.asksaveasfilename if save
                  else filedialog.askopenfilename)(
                filetypes=filetypes or [("Images", "*.png *.jpg *.jpeg "
                                         "*.bmp"), ("All", "*.*")])
            if fn:
                var.set(fn)
        ttk.Button(row, text="Browse", command=browse).pack(side="left")
        return row

    def preview_pane(parent, key, title):
        frame = ttk.LabelFrame(parent, text=title)
        frame.pack(side="left", padx=4, pady=4)
        lbl = ttk.Label(frame, text="(none)")
        lbl.pack(padx=4, pady=4)

        def show(path):
            try:
                photo = tk.PhotoImage(data=preview_ppm_bytes(path))
            except Exception:
                lbl.configure(text="(preview unavailable)", image="")
                return
            photo_refs[key] = photo             # prevent GC
            lbl.configure(image=photo, text="")
        return show

    # ---- EMBED tab
    et = ttk.Frame(nb)
    nb.add(et, text="EMBED")
    cover_v = tk.StringVar()
    wm_v = tk.StringVar()
    out_v = tk.StringVar()
    pwd_v = tk.StringVar()
    alpha_v = tk.DoubleVar(value=0.12)
    color_v = tk.BooleanVar(value=False)
    blocked_v = tk.BooleanVar(value=False)
    info_v = tk.StringVar(value="-")

    previews = ttk.Frame(et)
    show_host = preview_pane(previews, "host", "Host image")
    show_stego = preview_pane(previews, "stego", "Stego result")

    def on_cover_change(*_):
        p = cover_v.get()
        if p:
            stego_p, meta_p, wm_p = default_paths(p)
            out_v.set(stego_p)
            x_stego_v.set(stego_p)
            x_meta_v.set(meta_p)
            x_out_v.set(wm_p)
            if os.path.exists(p):
                show_host(p)                    # preview on pick
    cover_v.trace_add("write", on_cover_change)

    file_row(et, "Host image", cover_v)
    file_row(et, "Watermark", wm_v)
    file_row(et, "Output", out_v, save=True)
    row = ttk.Frame(et)
    row.pack(fill="x", pady=2)
    ttk.Label(row, text="Password").pack(side="left")
    ttk.Entry(row, textvariable=pwd_v, show="*").pack(side="left")
    ttk.Label(row, text="Alpha").pack(side="left", padx=(12, 0))
    ttk.Scale(row, from_=0.01, to=0.30, variable=alpha_v,
              orient="horizontal", length=160).pack(side="left")
    ttk.Spinbox(row, from_=0.01, to=0.30, increment=0.01,
                textvariable=alpha_v, width=6).pack(side="left")
    ttk.Checkbutton(row, text="Color (RGB)",
                    variable=color_v).pack(side="left", padx=8)
    ttk.Checkbutton(row, text="Blocked (fast)",
                    variable=blocked_v).pack(side="left")
    ttk.Label(et, textvariable=info_v, wraplength=560).pack(fill="x")

    def do_embed():
        try:
            # DoubleVar.get raises TclError on non-numeric spinbox text
            # BEFORE the handler's own try can show it — surface it in
            # the info label like every other handler error
            alpha = alpha_v.get()
        except tk.TclError:
            info_v.set("ERROR: alpha must be a number (e.g. 0.12).")
            return
        res = handle_embed(cover_v.get(), wm_v.get(), out_v.get(),
                           pwd_v.get(), alpha, color_v.get(),
                           blocked_v.get(), device=device)
        info_v.set(res.message)
        if res.preview_path:
            show_stego(res.preview_path)
    ttk.Button(et, text="EMBED WATERMARK", command=do_embed).pack(pady=6)
    previews.pack(fill="x")

    # ---- EXTRACT tab
    xt = ttk.Frame(nb)
    nb.add(xt, text="EXTRACT")
    x_stego_v = tk.StringVar()
    x_meta_v = tk.StringVar()
    x_out_v = tk.StringVar()
    x_pwd_v = tk.StringVar()
    x_info_v = tk.StringVar(value="-")
    file_row(xt, "Stego image", x_stego_v)
    file_row(xt, "Meta (.npz)", x_meta_v,
             filetypes=[("NPZ", "*.npz")])
    file_row(xt, "Output", x_out_v, save=True)
    row = ttk.Frame(xt)
    row.pack(fill="x", pady=2)
    ttk.Label(row, text="Password").pack(side="left")
    ttk.Entry(row, textvariable=x_pwd_v, show="*").pack(side="left")
    ttk.Label(xt, textvariable=x_info_v, wraplength=560).pack(fill="x")
    x_previews = ttk.Frame(xt)
    show_wm = preview_pane(x_previews, "wm", "Extracted watermark")

    def do_extract():
        res = handle_extract(x_stego_v.get(), x_meta_v.get(),
                             x_out_v.get(), x_pwd_v.get(), device=device)
        x_info_v.set(res.message)
        if res.preview_path:
            show_wm(res.preview_path)
    ttk.Button(xt, text="EXTRACT (password required)",
               command=do_extract).pack(pady=6)
    x_previews.pack(fill="x")

    # ---- DETECT tab
    dt = ttk.Frame(nb)
    nb.add(dt, text="DETECT")
    d_stego_v = tk.StringVar()
    d_meta_v = tk.StringVar()
    d_info_v = tk.StringVar(value="Score: -")
    file_row(dt, "Stego image", d_stego_v)
    file_row(dt, "Meta (.npz)", d_meta_v, filetypes=[("NPZ", "*.npz")])
    ttk.Label(dt, textvariable=d_info_v).pack(fill="x")

    def do_detect():
        d_info_v.set(handle_detect(d_stego_v.get(), d_meta_v.get(),
                                   device=device).message)
    ttk.Button(dt, text="DETECT", command=do_detect).pack(pady=6)

    root.geometry("720x560")
    return {
        "notebook": nb,
        "embed": do_embed, "extract": do_extract, "detect": do_detect,
        "vars": {
            "cover": cover_v, "wm": wm_v, "out": out_v, "pwd": pwd_v,
            "alpha": alpha_v, "color": color_v, "blocked": blocked_v,
            "info": info_v,
            "x_stego": x_stego_v, "x_meta": x_meta_v, "x_out": x_out_v,
            "x_pwd": x_pwd_v, "x_info": x_info_v,
            "d_stego": d_stego_v, "d_meta": d_meta_v, "d_info": d_info_v,
        },
    }


def main():  # pragma: no cover - interactive
    import tkinter as tk

    root = tk.Tk()
    build_ui(root)
    root.mainloop()


if __name__ == "__main__":  # pragma: no cover
    main()
