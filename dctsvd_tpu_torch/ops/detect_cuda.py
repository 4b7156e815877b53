"""The blocked detect statistic: K9 ``band_scores`` (``csrc/detect.cu``) and
its plain twin.

K9 replaces the XLA fusion of ``dctsvd_tpu/models/blocked.py::_band_nc``
(:1191) with ``band_scale_damp`` (:1130), ``band_presence_damp`` (:1154),
the rectified estimate of ``detect_gray`` / ``detect_color``
(:1254-1255, :1273-1274), the median (:1230) and ``detect_color``'s
channel mean; no ``pl.pallas_call``. From the stego and cover spectra
``s_cw``, ``sc`` [..., (C,) N, 8] and the watermark's ``sw`` [(C,) N, 8]
of an hb × wb block grid, over the first k columns:

    ŝ = max(s_cw − sc, 0) / max(α, 1e-8), never stored;
    per band of the g × g grid (g = max(1, min(grid, hb, wb))), over its
    m·k values: NC(sw, ŝ) · scale damp · presence damp (the docstrings of
    models/blocked.py::band_scale_damp and band_presence_damp);
    per frame: each plane's median of its g² band scores, then the mean
    over the planes.

``reduce=False`` returns the band scores [..., (C,) g²] (parallel/plane.py
gathers every shard's bands and takes one median).

Every sum runs in one fixed order, the kernel's: thread t of a band's 256
adds blocks t, t + 256, ... (columns 0..k-1 of each) in turn, then the 256
partials add in a tree (a warp's 32 lanes halved at 16, 8, 4, 2, 1, then
the 8 warp sums at 4, 2, 1). The means come first; the centred sums take a
second pass. Every division is one IEEE division (``torch.div`` of two
tensors on the device: torch turns a division by a Python number into a
product by its reciprocal, which rounds twice). So the twin, run on the
card, is bit-equal to the kernel, and a frame's score is the same alone,
in a shard or in any batch.

How the values reach the kernel's registers (16-byte row loads, a band
held in registers for the second pass) is chosen by :func:`band_plan`
from the pointers, strides and band size; it changes no sum.

The wrapper runs its twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises. It counts its launches in ``.launches``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from dctsvd_tpu_torch.ops.cta_tree import THREADS, tree
from dctsvd_tpu_torch.ops.tail_cuda import _f32
from dctsvd_tpu_torch.ops.wm_cuda import _device_ok
from dctsvd_tpu_torch.utils import kernels
from dctsvd_tpu_torch.utils.config import BLOCK

__all__ = ["band_scores", "band_scores_plain", "band_grid", "band_plan",
           "median_last"]

K_MAX = BLOCK     # K9 is compiled for k = 1..8
#: Rows of THREADS blocks a thread keeps in registers (csrc/detect.cu
#: kBandRows): a band of at most THREADS · RESIDENT_ROWS blocks is read once.
RESIDENT_ROWS = 8


def band_grid(hb: int, wb: int, grid: int) -> tuple:
    """(g, gh, gw): the g × g bands of an hb × wb block grid, each gh × gw
    blocks (to_bands' cut: the blocks past g·gh rows or g·gw columns are
    in no band)."""
    g = max(1, min(grid, hb, wb))
    return g, hb // g, wb // g


def band_plan(hb: int, wb: int, grid: int, ptrs, strides) -> tuple:
    """(vector, resident, rows) of K9 on an hb × wb block grid cut into
    g × g bands, with the s_cw, sc and sw rows at the data pointers
    ``ptrs`` and the frame and plane strides ``strides`` (elements).
    vector: every row on a 16-byte boundary (each pointer on one, each
    stride a multiple of 4 floats; sc's frame stride may be 0), so a row's
    first k values take one 16-byte load (two for k > 4); else the scalar
    instance loads 4 bytes at a time. rows: the rows of THREADS blocks a
    band spans; resident: at most RESIDENT_ROWS of them, so each thread
    loads all its rows before the sums and keeps them for the second pass;
    larger bands (4K frames, an 8K shard's) read the band again."""
    _, gh, gw = band_grid(hb, wb, grid)
    rows = -(-gh * gw // THREADS)
    vector = (all(p % 16 == 0 for p in ptrs)
              and all(s % 4 == 0 for s in strides))
    return vector, rows <= RESIDENT_ROWS, rows


def median_last(x: torch.Tensor) -> torch.Tensor:
    """jnp.median over the last axis: the mean of the two middle values
    for an even count (torch.median would return the lower one)."""
    n = x.shape[-1]
    srt = torch.sort(x, dim=-1).values
    if n % 2:
        return srt[..., n // 2]
    return (srt[..., n // 2 - 1] + srt[..., n // 2]) * 0.5


def _layout(s_cw, sc, sw, alpha, k, hb, wb):
    """Check the inputs; (frame dims, channel dims)."""
    for name, t in (("s_cw", s_cw), ("sc", sc), ("sw", sw),
                    ("alpha", alpha)):
        if t.dtype != torch.float32:
            raise ValueError(f"band_scores takes float32 {name}, got "
                             f"{t.dtype}")
    if not 1 <= k <= K_MAX:
        raise ValueError(f"k must be in 1..{K_MAX}, got {k}")
    if sw.ndim not in (2, 3) or sw.shape[-1] != BLOCK:
        raise ValueError(f"sw must be [(C,) N, {BLOCK}], got "
                         f"{tuple(sw.shape)}")
    if hb < 1 or wb < 1 or sw.shape[-2] != hb * wb:
        raise ValueError(f"sw has {sw.shape[-2]} blocks, the {hb}x{wb} "
                         f"block grid {hb * wb}")
    tail = sw.ndim
    if s_cw.ndim < tail or s_cw.shape[s_cw.ndim - tail:] != sw.shape:
        raise ValueError(f"s_cw must be [..., {', '.join(map(str, sw.shape))}"
                         f"], got {tuple(s_cw.shape)}")
    try:
        shape = torch.broadcast_shapes(sc.shape, s_cw.shape)
    except RuntimeError:
        shape = None
    if shape != s_cw.shape:
        raise ValueError(f"sc {tuple(sc.shape)} does not broadcast to s_cw "
                         f"{tuple(s_cw.shape)}")
    if alpha.numel() != 1:
        raise ValueError(f"band_scores takes one alpha, got "
                         f"{tuple(alpha.shape)}")
    return tuple(s_cw.shape[:s_cw.ndim - tail]), tuple(sw.shape[:-2])


def _walk(x: torch.Tensor, hb: int, wb: int, grid: int) -> torch.Tensor:
    """[..., N, k] -> [..., g², R, THREADS, k]: each band's m blocks in
    the kernel's walk (block j of the band at row j // gw, column j % gw;
    thread t takes blocks t, t + THREADS, ...), zero-padded to R whole
    rows of THREADS."""
    g, gh, gw = band_grid(hb, wb, grid)
    *lead, _, k = x.shape
    x = x.reshape(*lead, hb, wb, k)[..., :g * gh, :g * gw, :]
    x = x.reshape(*lead, g, gh, g, gw, k).transpose(-4, -3)
    x = x.reshape(*lead, g * g, gh * gw, k)
    rows = -(-gh * gw // THREADS)
    x = F.pad(x, (0, 0, 0, rows * THREADS - gh * gw))
    return x.reshape(*lead, g * g, rows, THREADS, k)


def band_scores_plain(s_cw: torch.Tensor, sc: torch.Tensor, sw: torch.Tensor,
                      alpha: torch.Tensor, k: int, hb: int, wb: int,
                      grid: int = 4, reduce: bool = True) -> torch.Tensor:
    """Plain twin of K9, one PyTorch op a step in the kernel's order (see
    the module docstring)."""
    lead, cdims = _layout(s_cw, sc, sw, alpha, k, hb, wb)
    dev = s_cw.device
    g, gh, gw = band_grid(hb, wb, grid)
    m = gh * gw
    est = torch.div(torch.clamp(s_cw[..., :k] - sc[..., :k], min=0.0),
                    torch.clamp(alpha.reshape(()), min=1e-8))
    a = _walk(sw[..., :k], hb, wb, grid)           # [(C,) g², R, T, k]
    b = _walk(est, hb, wb, grid)                   # [..., (C,) g², R, T, k]
    rows = a.shape[-3]
    valid = (torch.arange(rows * THREADS, device=dev) < m).reshape(
        rows, THREADS)
    zero = _f32(0.0, dev)

    # pass 1: sum a, sum b, sum a a, sum b b, and a, b over column 0
    v = [zero] * 6
    for r in range(rows):
        for i in range(k):
            ai, bi = a[..., r, :, i], b[..., r, :, i]
            v[0], v[1] = v[0] + ai, v[1] + bi
            v[2], v[3] = v[2] + ai * ai, v[3] + bi * bi
            if i == 0:
                v[4], v[5] = v[4] + ai, v[5] + bi
    v = [tree(t) for t in v]
    n_all, n0 = _f32(m * k, dev), _f32(m, dev)
    ma, mb = (torch.div(t, n_all)[..., None] for t in v[:2])
    ma0, mb0 = (torch.div(t, n0)[..., None] for t in v[4:])

    # pass 2: the centred sums, the pad lanes zeroed after centring
    u = [zero] * 6
    for r in range(rows):
        ok = valid[r]
        for i in range(k):
            ai, bi = a[..., r, :, i], b[..., r, :, i]
            da = torch.where(ok, ai - ma, zero)
            db = torch.where(ok, bi - mb, zero)
            u[0], u[1], u[2] = u[0] + da * da, u[1] + db * db, u[2] + da * db
            if i == 0:
                da0 = torch.where(ok, ai - ma0, zero)
                db0 = torch.where(ok, bi - mb0, zero)
                u[3] = u[3] + da0 * da0
                u[4] = u[4] + db0 * db0
                u[5] = u[5] + da0 * db0
    u = [tree(t) for t in u]

    eps = _f32(1e-8, dev)
    one = _f32(1.0, dev)

    def nc(sxy, sxx, syy):
        return torch.div(sxy, torch.sqrt(sxx) * torch.sqrt(syy) + eps)

    r_ = torch.div(torch.sqrt(v[3]), torch.sqrt(v[2]) + eps)
    over = torch.clamp(torch.log2(torch.clamp(r_, min=1e-9)), min=0.0)
    o2 = over * over
    scale = torch.div(one, one + o2 * o2)
    knee = _f32(0.05, dev) + torch.div(_f32(1.3, dev), torch.sqrt(n0))
    presence = torch.clamp(torch.div(nc(u[5], u[3], u[4]) - knee,
                                     _f32(0.30, dev)), 0.0, 1.0)
    bands = nc(u[2], u[0], u[1]) * scale * presence   # [..., (C,) g²]
    if not reduce:
        return bands
    med = median_last(bands)
    if not cdims:
        return med
    total = med[..., 0]
    for c in range(1, cdims[0]):
        total = total + med[..., c]
    return torch.div(total, _f32(cdims[0], dev))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with rows of 8 contiguous floats (a copy where they are not)."""
    if (t.shape[-2] > 1 and t.stride(-2) != BLOCK) or t.stride(-1) != 1:
        return t.contiguous()
    return t


def band_scores(s_cw: torch.Tensor, sc: torch.Tensor, sw: torch.Tensor,
                alpha: torch.Tensor, k: int, hb: int, wb: int,
                grid: int = 4, reduce: bool = True) -> torch.Tensor:
    """The detect statistic (see the module docstring): K9 on CUDA tensors,
    its plain twin on CPU tensors. ``s_cw`` f32 [..., (C,) N, 8], ``sc``
    broadcastable to it (a per-frame [..., (C,) N, 8] or one shared
    [(C,) N, 8]), ``sw`` [(C,) N, 8] with N = hb·wb, ``alpha`` one f32 on
    the device; returns the frame scores [...] or, with ``reduce=False``,
    the band scores [..., (C,) g²]."""
    lead, cdims = _layout(s_cw, sc, sw, alpha, k, hb, wb)
    if _device_ok("band_scores", s_cw, sc, sw, alpha):
        return band_scores_plain(s_cw, sc, sw, alpha, k, hb, wb, grid,
                                 reduce)
    g, _, _ = band_grid(hb, wb, grid)
    frames, c, n = math.prod(lead), (cdims or (1,))[0], hb * wb
    s = _rows(s_cw.reshape(frames, c, n, BLOCK))
    q = _rows(torch.broadcast_to(sc, s_cw.shape).reshape(frames, c, n, BLOCK))
    w = _rows(sw.reshape(c, n, BLOCK))
    bands = torch.empty((frames, c, g * g), dtype=torch.float32,
                        device=s_cw.device)
    out = (torch.empty((frames,), dtype=torch.float32, device=s_cw.device)
           if reduce else None)
    if frames:
        strides = (s.stride(0), s.stride(1), q.stride(0), q.stride(1),
                   w.stride(0))
        vector, resident, _ = band_plan(
            hb, wb, grid, (s.data_ptr(), q.data_ptr(), w.data_ptr()),
            strides)
        kernels.launch("dctsvd_band_scores", s_cw.device, s, strides[0],
                       strides[1], q, strides[2], strides[3], w, strides[4],
                       alpha, bands, out, frames, c, hb, wb, g, k,
                       int(vector), int(resident))
        band_scores.launches += 1
    if reduce:
        return out.reshape(lead)
    return bands.reshape(*lead, *cdims, g * g)


band_scores.launches = 0
