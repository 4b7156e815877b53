"""The port's GUI handlers (dctsvd_tpu_torch/gui.py) on the CPU: every
case of tests/test_gui.py with ``device='cpu'``, its pure helpers equal
to the JAX package's, and metas interchangeable between the two
packages' handlers.

The tkinter widget layer needs a display; its smoke case skips without
one, as in tests/test_gui.py."""

import cv2
import pytest

import dctsvd_tpu.gui as jgui
import dctsvd_tpu_torch.gui as gui

CPU = "cpu"


@pytest.fixture()
def images(tmp_path, make_image):
    cp = str(tmp_path / "host.png")
    wp = str(tmp_path / "wm.png")
    cv2.imwrite(cp, make_image(96, 96))
    cv2.imwrite(wp, make_image(48, 48, blur=False))
    return cp, wp


def test_gui_imports_headless():
    """Importing the module pulls in no tkinter (build_ui and main do),
    and the handlers run on the card unless told otherwise."""
    import subprocess
    import sys
    assert callable(gui.main) and callable(gui.build_ui)
    subprocess.run([sys.executable, "-c",
                    "import sys, dctsvd_tpu_torch.gui; "
                    "assert 'tkinter' not in sys.modules"], check=True)
    for fn in (gui.handle_embed, gui.handle_extract, gui.handle_detect,
               gui.build_ui):
        assert fn.__defaults__[-1] == "cuda"


def test_embed_refuses_empty_password(images):
    cp, wp = images
    res = gui.handle_embed(cp, wp, "", password="", alpha=0.12,
                           color=False, blocked=True, device=CPU)
    assert not res.ok
    assert "password required" in res.message
    assert res == jgui.handle_embed(cp, wp, "", password="", alpha=0.12,
                                    color=False, blocked=True)


@pytest.mark.parametrize("blocked", [True, False])
def test_embed_extract_detect_handlers_roundtrip(images, tmp_path, blocked):
    cp, wp = images
    out = str(tmp_path / "s.png")
    res = gui.handle_embed(cp, wp, out, password="pw", alpha=0.12,
                           color=False, blocked=blocked, device=CPU)
    assert res.ok, res.message
    assert "PSNR" in res.message
    assert res.preview_path and res.preview_path.endswith(".png")

    meta = str(tmp_path / "s_meta.npz")
    d = gui.handle_detect(res.preview_path, meta, device=CPU)
    assert d.ok and "Watermarked" in d.message

    x = gui.handle_extract(res.preview_path, meta,
                           str(tmp_path / "x.png"), "pw", device=CPU)
    assert x.ok, x.message
    assert x.preview_path

    # wrong password surfaces as an error message, not an exception
    bad = gui.handle_extract(res.preview_path, meta,
                             str(tmp_path / "y.png"), "WRONG", device=CPU)
    assert not bad.ok and "ERROR" in bad.message


def test_handlers_report_missing_inputs():
    r = gui.handle_embed("", "", "", password="pw", alpha=0.1,
                         color=False, blocked=False, device=CPU)
    assert not r.ok and "choose" in r.message
    assert not gui.handle_extract("", "", "", "pw", device=CPU).ok
    assert not gui.handle_detect("", "", device=CPU).ok
    # nonexistent files -> error result, no exception
    r = gui.handle_detect("/nonexistent/a.png", "/nonexistent/m.npz",
                          device=CPU)
    assert not r.ok and r.message.startswith("ERROR")
    for port, ref in ((gui.handle_extract("", "", "", "pw", device=CPU),
                       jgui.handle_extract("", "", "", "pw")),
                      (gui.handle_detect("", "", device=CPU),
                       jgui.handle_detect("", ""))):
        assert port == ref


def test_default_paths():
    s, m, w = gui.default_paths("/tmp/pic.jpg")
    assert s == "/tmp/pic_stego.png"
    assert m == "/tmp/pic_stego_meta.npz"
    assert w == "/tmp/pic_wm.png"
    for p in ("/tmp/pic.jpg", "a/b.c/d", "x.tar.gz", "noext"):
        assert gui.default_paths(p) == jgui.default_paths(p)


def test_preview_ppm_bytes(images):
    cp, wp = images
    data = gui.preview_ppm_bytes(cp, max_side=40)
    assert data.startswith(b"P6 ")
    header, _, rest = data.partition(b"\n")
    _, w, h, maxval = header.split()
    assert int(maxval) == 255
    assert max(int(w), int(h)) <= 40
    assert len(rest) == int(w) * int(h) * 3
    for path, side in ((cp, 40), (cp, 220), (wp, 17)):
        assert gui.preview_ppm_bytes(path, max_side=side) == \
            jgui.preview_ppm_bytes(path, max_side=side)
    with pytest.raises(ValueError):
        gui.preview_ppm_bytes("/nonexistent.png")


def test_handle_embed_rejects_out_of_range_alpha():
    for bad in (0.0, 3.0, -0.1, 0.45, 0.005):
        r = gui.handle_embed("c.png", "w.png", "", password="pw",
                             alpha=bad, color=False, blocked=False,
                             device=CPU)
        assert not r.ok and "alpha" in r.message
        assert r == jgui.handle_embed("c.png", "w.png", "", password="pw",
                                      alpha=bad, color=False, blocked=False)


@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("embedder", ["port", "jax"])
def test_metas_interchangeable(images, tmp_path, embedder, blocked):
    """A stego and meta from one package's embed handler extract and
    detect through the other's handlers."""
    cp, wp = images
    out = str(tmp_path / "s.png")
    meta = str(tmp_path / "s_meta.npz")
    if embedder == "port":
        res = gui.handle_embed(cp, wp, out, password="pw", alpha=0.12,
                               color=True, blocked=blocked, device=CPU)
        d = jgui.handle_detect(out, meta)
        x = jgui.handle_extract(out, meta, str(tmp_path / "x.png"), "pw")
        bad = jgui.handle_extract(out, meta, str(tmp_path / "y.png"), "no")
    else:
        res = jgui.handle_embed(cp, wp, out, password="pw", alpha=0.12,
                                color=True, blocked=blocked)
        d = gui.handle_detect(out, meta, device=CPU)
        x = gui.handle_extract(out, meta, str(tmp_path / "x.png"), "pw",
                               device=CPU)
        bad = gui.handle_extract(out, meta, str(tmp_path / "y.png"), "no",
                                 device=CPU)
    assert res.ok, res.message
    assert d.ok and "Watermarked" in d.message, d.message
    assert x.ok and cv2.imread(x.preview_path) is not None, x.message
    assert not bad.ok and bad.message.startswith("ERROR")


def _try_tk_root():
    """A Tk root, or None when no display server is reachable."""
    try:
        import tkinter as tk
        return tk.Tk()
    except Exception:
        return None


def test_gui_widget_shell_smoke(images, tmp_path):
    """Drive the real widget shell wherever a display exists. Skipped
    (not failed) without a display server — the handler logic itself is
    covered headlessly above."""
    root = _try_tk_root()
    if root is None:
        pytest.skip("no display server (Tk root unavailable)")
    try:
        ui = gui.build_ui(root, device=CPU)
        v = ui["vars"]
        cp, wp = images
        out = str(tmp_path / "g.png")
        v["cover"].set(cp)          # triggers the trace -> extract prefill
        v["wm"].set(wp)
        v["out"].set(out)
        v["pwd"].set("pw")
        v["alpha"].set(0.12)
        v["blocked"].set(True)
        ui["embed"]()
        assert "PSNR" in v["info"].get(), v["info"].get()
        assert v["x_stego"].get().endswith("_stego.png")

        v["d_stego"].set(out)
        v["d_meta"].set(str(tmp_path / "g_meta.npz"))
        ui["detect"]()
        assert "Watermarked" in v["d_info"].get(), v["d_info"].get()

        v["x_stego"].set(out)
        v["x_meta"].set(str(tmp_path / "g_meta.npz"))
        v["x_out"].set(str(tmp_path / "g_wm.png"))
        v["x_pwd"].set("pw")
        ui["extract"]()
        assert v["x_info"].get().startswith("Extracted"), v["x_info"].get()
        root.update()
    finally:
        root.destroy()
