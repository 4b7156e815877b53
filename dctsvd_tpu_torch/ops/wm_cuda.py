"""Blocked watermark kernels and their plain twins: K1 (spectrum), K2
(V-free embed), K3 (embed + verification spectrum), K2r (recon embed) and
K1g (Gram spectrum).

  - K1 ``spectrum_blocks`` (``csrc/wm_kernels.cu``) replaces the Pallas
    kernel ``dctsvd_tpu/ops/wm_pallas.py::_make_spectrum_kernel`` (called
    through ``spectrum_plane_blocks(method='onesided')``): values-only
    one-sided Jacobi on every 8×8 PIXEL block at the replayed schedule,
    sorted descending. S(D·X·Dᵀ) = S(X), so no DCT is needed.
  - K2 ``embed_blocks`` (``csrc/wm_paint.cuh``, one instance per k, as
    the Pallas kernel closes over k) replaces
    ``_make_embed_kernel_delta`` (called through
    ``embed_plane_blocks(variant='delta')``): Jacobi without V,
    sorted raw columns g_j = s_j·u_j, then the rank-k V-free paint of
    ``wm_pallas._paint_cols`` on the UN-rotated input columns x_c:

      y_c = x_c + Σ_{j<k} g_j · (sws_j · rsqrt(‖Xᵀg_j‖² + s₀²‖g_j‖²·1e-10
                                 + 1e-30) · rsqrt(‖g_j‖² + 1e-30) · (Xᵀg_j)_c)

    then an optional clip and truncation to u8.
  - K3 ``roundtrip_frames_blocks`` (``csrc/wm_paint.cuh``) replaces
    ``_make_embed_verify_kernel`` (called through
    ``roundtrip_frames_blocks``): K2's paint with u8 output, then K1 on
    the rounded block while it is still on chip. Its s_cw equals K1 on the
    returned stego bit for bit, so its twin is K2's twin followed by K1's.
  - K2r ``embed_blocks_recon`` (``csrc/wm_variants.cu``) replaces
    ``_make_embed_kernel`` (called through
    ``embed_plane_blocks(variant='recon')``): Jacobi with U and V, then
    column k of the marked block is Σ_j u_j·(S'_j·V[k, j]), S' = s + sws;
    f32 output only.
  - K1g ``spectrum_blocks_gram`` (``csrc/wm_variants.cu``) replaces
    ``_make_spectrum_gram_kernel`` (called through
    ``spectrum_plane_blocks(method='gram')``): two-sided Jacobi on the 36
    entries of XᵀX with K0's rotation and pair prefix, then
    sqrt(max(a_ii, 0)), sorted.

``embed_blocks(variant=)`` and ``spectrum_blocks(method=)`` reach K2r and
K1g the way the JAX package's wrappers reach their variants; the defaults
are K2 and K1.

Layouts are the JAX package's: u8 or f32 planes ``[..., H, W]``, or
channels-last frames ``[..., H, W, C]`` (``channels_last``); H and W are
multiples of 8. Plane p of the flattened ``[..., (C,)]`` lead takes
``sws[p % Csws]``. Spectra come back as ``[..., (C,) N, 8]`` with the
row-major block index ``n = by·Wb + bx``.

Each wrapper runs its twin only for CPU tensors; for a CUDA tensor it
launches its kernel or raises. Each counts its own launches in
``.launches``.
"""

from __future__ import annotations

import torch

from dctsvd_tpu_torch.ops import dct
from dctsvd_tpu_torch.ops.svd_cuda import (B, PAIRS, _jacobi8, _rotation,
                                           _schedule, _sort8, _sum_rows)
from dctsvd_tpu_torch.utils import kernels

__all__ = ["PAIRS", "sched_split", "sched_join", "spectrum_blocks",
           "embed_blocks", "roundtrip_frames_blocks", "embed_blocks_recon",
           "spectrum_blocks_gram", "spectrum_blocks_plain",
           "embed_blocks_plain", "roundtrip_frames_blocks_plain",
           "embed_blocks_recon_plain", "spectrum_blocks_gram_plain"]

_SWEEPS_DEFAULT = 4
EMBED_VARIANTS = ("delta", "recon")
# K2r gives each warp 32 // C whole pixel blocks (csrc/wm_variants.cu).
RECON_MAX_CHANNELS = 32
SPECTRUM_METHODS = ("onesided", "gram")


def sched_split(sweeps) -> tuple:
    """Quantize a sweep value onto the pair grid and split it into the two
    integers that serialize it in a meta: (full sweeps, extra pairs 0..27)."""
    return _schedule(sweeps)


def sched_join(full: int, xpairs: int):
    """Inverse of sched_split: an int when the schedule is integral, else
    the float ``full + xpairs/28``, which _schedule() recovers exactly."""
    full, xpairs = int(full), int(xpairs)
    full += xpairs // len(PAIRS)
    xpairs %= len(PAIRS)
    return full if xpairs == 0 else full + xpairs / len(PAIRS)


def _as_planes(x: torch.Tensor, channels_last: bool):
    """Input -> ([P, H, W] f32 planes, lead shape incl. C)."""
    if channels_last:
        x = torch.movedim(x, -1, -3)
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    return x.reshape(-1, h, w).to(torch.float32), tuple(lead)


def _check(x: torch.Tensor, channels_last: bool):
    if x.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"blocks kernels take uint8 or float32, got {x.dtype}")
    if x.ndim < (3 if channels_last else 2):
        raise ValueError(f"bad input rank {tuple(x.shape)}")
    h, w = (x.shape[-3], x.shape[-2]) if channels_last else x.shape[-2:]
    if h % B or w % B:
        raise ValueError("dims must be multiples of 8 (pad first)")
    return h, w


def _schedule_checked(sweeps):
    full, extra = _schedule(sweeps)
    if full == 0 and extra == 0:
        raise ValueError("a 0-sweep schedule returns column norms, not "
                         "singular values (map meta sweeps 0 through "
                         "models.blocked.replay_sweeps)")
    return full, extra


def _layout(x: torch.Tensor, channels_last: bool):
    """(P planes, C channels interleaved per pixel, H, W) of the input."""
    if channels_last:
        *lead, h, w, c = x.shape
    else:
        *lead, h, w = x.shape
        c = 1
    p = c
    for d in lead:
        p *= d
    return p, c, h, w


def _check_sws(x: torch.Tensor, sws: torch.Tensor, channels_last: bool,
               k: int) -> None:
    p, _, h, w = _layout(x, channels_last)
    if sws.ndim != 3 or sws.shape[1:] != ((h // B) * (w // B), B):
        raise ValueError(f"sws must be [C, N, 8], got {tuple(sws.shape)}")
    if sws.shape[0] == 0 or p % sws.shape[0]:
        raise ValueError(f"sws channel count {sws.shape[0]} must divide "
                         f"the plane count {p}")
    if not 1 <= k <= B:
        raise ValueError(f"k must be in 1..8, got {k}")


def _device_ok(name: str, *tensors) -> bool:
    """True for CPU tensors (the twin runs), False for CUDA tensors on one
    device (the kernel runs); raises for anything else."""
    dev = tensors[0].device
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: unsupported devices "
                         f"{', '.join(str(t.device) for t in tensors)}")
    return False


def _columns(x: torch.Tensor, channels_last: bool, csws: int = 1):
    """The un-rotated block columns of the input: 8 tensors
    [P/csws, csws, N, 8], plus (P, lead, H, W, N)."""
    h, w = _check(x, channels_last)
    planes, lead = _as_planes(x, channels_last)
    p = planes.shape[0]
    n = (h // B) * (w // B)
    blocks = dct.blockify(planes).reshape(p // csws, csws, n, B, B)
    return [blocks[..., :, c] for c in range(B)], (p, lead, h, w, n)


def _unblock(y: torch.Tensor, lead, h: int, w: int,
             channels_last: bool) -> torch.Tensor:
    """[P, N, 8, 8] marked blocks -> the input's layout."""
    y = dct.unblockify(y, h, w).reshape(*lead, h, w)
    return torch.movedim(y, -3, -1) if channels_last else y


def spectrum_blocks_plain(x: torch.Tensor, sweeps=_SWEEPS_DEFAULT,
                          channels_last: bool = False) -> torch.Tensor:
    """Plain twin of K1."""
    full, extra = _schedule_checked(sweeps)
    g, (_, lead, _, _, n) = _columns(x, channels_last)
    s = _jacobi8(g, full, extra)
    _sort8(s)
    return torch.stack(s, dim=-1).reshape(*lead, n, B)


def spectrum_blocks_gram_plain(x: torch.Tensor, sweeps=_SWEEPS_DEFAULT,
                               channels_last: bool = False) -> torch.Tensor:
    """Plain twin of K1g: two-sided Jacobi on the Gram matrix XᵀX, carried
    as its 36 upper-triangle entries a[(i, j)], i <= j."""
    full, extra = _schedule_checked(sweeps)
    xc, (_, lead, _, _, n) = _columns(x, channels_last)
    a = {(i, j): _sum_rows(xc[i] * xc[j])
         for i in range(B) for j in range(i, B)}

    def key(i, j):
        return (i, j) if i <= j else (j, i)

    def rotate(pairs):
        for p, q in pairs:
            app, aqq, apq = a[(p, p)], a[(q, q)], a[(p, q)]
            c, s, t = _rotation(app, aqq, apq)
            for r in range(B):
                if r in (p, q):
                    continue
                kp, kq = key(r, p), key(r, q)
                arp, arq = a[kp], a[kq]
                a[kp] = c * arp - s * arq
                a[kq] = s * arp + c * arq
            a[(p, p)] = app - t * apq
            a[(q, q)] = aqq + t * apq
            a[(p, q)] = torch.zeros_like(apq)      # annihilated exactly

    for _ in range(full):
        rotate(PAIRS)
    if extra:
        rotate(PAIRS[:extra])
    s = [torch.sqrt(torch.clamp(a[(i, i)], min=0.0)) for i in range(B)]
    _sort8(s)
    return torch.stack(s, dim=-1).reshape(*lead, n, B)


def embed_blocks_plain(x: torch.Tensor, sws: torch.Tensor,
                       sweeps=_SWEEPS_DEFAULT, k: int = B,
                       out_u8: bool = False, channels_last: bool = False):
    """Plain twin of K2: (marked in the input layout, sc [..., (C,) N, 8])."""
    full, extra = _schedule_checked(sweeps)
    xc, (p, lead, h, w, n) = _columns(x, channels_last, sws.shape[0])
    g = list(xc)
    s = _jacobi8(g, full, extra)
    _sort8(s, g)

    sws = sws.to(torch.float32)
    s0sq = s[0] * s[0]
    ycols = list(xc)
    for j in range(k):
        nj = s[j] * s[j]                               # ‖g_j‖²
        vj = [_sum_rows(xc[c] * g[j]) for c in range(B)]   # (Xᵀg_j)[c]
        nrm2 = vj[0] * vj[0]
        for c in range(1, B):
            nrm2 = nrm2 + vj[c] * vj[c]
        coef = (sws[:, :, j]
                * torch.rsqrt(nrm2 + s0sq * nj * 1e-10 + 1e-30)
                * torch.rsqrt(nj + 1e-30))
        for c in range(B):
            ycols[c] = ycols[c] + g[j] * (coef * vj[c])[..., None]
    y = torch.stack(ycols, dim=-1).reshape(p, n, B, B)
    if out_u8:
        y = y.clamp(0.0, 255.0).to(torch.uint8)
    sc = torch.stack(s, dim=-1).reshape(*lead, n, B)
    return _unblock(y, lead, h, w, channels_last), sc


def embed_blocks_recon_plain(x: torch.Tensor, sws: torch.Tensor,
                             sweeps=_SWEEPS_DEFAULT,
                             channels_last: bool = False):
    """Plain twin of K2r: (f32 marked in the input layout,
    sc [..., (C,) N, 8])."""
    full, extra = _schedule_checked(sweeps)
    g, (p, lead, h, w, n) = _columns(x, channels_last, sws.shape[0])
    eye = torch.eye(B, dtype=torch.float32, device=x.device)
    zeros = torch.zeros_like(g[0])
    v = [zeros + eye[i] for i in range(B)]
    s = _jacobi8(g, full, extra, v)
    u = [g[i] / torch.clamp(s[i], min=1e-30)[..., None] for i in range(B)]
    _sort8(s, u, v)

    sws = sws.to(torch.float32)
    s2 = [s[j] + sws[:, :, j] for j in range(B)]
    cols = []
    for c in range(B):                         # col c = Σ_j u_j·(S'_j·V[c, j])
        acc = u[0] * (s2[0] * v[0][..., c])[..., None]
        for j in range(1, B):
            acc = acc + u[j] * (s2[j] * v[j][..., c])[..., None]
        cols.append(acc)
    y = torch.stack(cols, dim=-1).reshape(p, n, B, B)
    sc = torch.stack(s, dim=-1).reshape(*lead, n, B)
    return _unblock(y, lead, h, w, channels_last), sc


def roundtrip_frames_blocks_plain(frames: torch.Tensor, sws: torch.Tensor,
                                  sweeps=_SWEEPS_DEFAULT, k: int = B):
    """Plain twin of K3: K2's twin with u8 output, then K1's twin on the
    stego it returns. (stego u8, sc, s_cw), sc and s_cw [..., C, N, 8]."""
    stego, sc = embed_blocks_plain(frames, sws, sweeps, k, out_u8=True,
                                   channels_last=True)
    return stego, sc, spectrum_blocks_plain(stego, sweeps,
                                            channels_last=True)


def _launch_layout(x: torch.Tensor, channels_last: bool):
    """What a launch needs: (contiguous x, P, C, H, W, lead of the
    [..., (C,) N, 8] result, N, an empty f32 [P, N, 8] for it)."""
    x = x.contiguous()
    p, c, h, w = _layout(x, channels_last)
    lead = x.shape[:-3] + (c,) if channels_last else x.shape[:-2]
    n = (h // B) * (w // B)
    out = torch.empty(p, n, B, dtype=torch.float32, device=x.device)
    return x, p, c, h, w, lead, n, out


def spectrum_blocks(x: torch.Tensor, sweeps=_SWEEPS_DEFAULT,
                    channels_last: bool = False,
                    method: str = "onesided") -> torch.Tensor:
    """Per-block singular values [..., (C,) N, 8]: K1 (``method=
    'onesided'``) or K1g (``'gram'``) on a CUDA tensor, its plain twin on
    a CPU tensor."""
    if method not in SPECTRUM_METHODS:
        raise ValueError(f"unknown spectrum method {method!r}; expected "
                         f"one of {SPECTRUM_METHODS}")
    if method == "gram":
        return spectrum_blocks_gram(x, sweeps, channels_last)
    if _device_ok("spectrum_blocks", x):
        return spectrum_blocks_plain(x, sweeps, channels_last)
    _check(x, channels_last)
    full, extra = _schedule_checked(sweeps)
    x, p, c, h, w, lead, n, out = _launch_layout(x, channels_last)
    if p:
        kernels.launch("dctsvd_spectrum_blocks", x.device, x,
                       int(x.dtype == torch.uint8), out, p, c, h, w, full,
                       extra)
        spectrum_blocks.launches += 1
    return out.reshape(*lead, n, B)


def spectrum_blocks_gram(x: torch.Tensor, sweeps=_SWEEPS_DEFAULT,
                         channels_last: bool = False) -> torch.Tensor:
    """Per-block singular values through the Gram matrix: K1g on a CUDA
    tensor, its plain twin on a CPU tensor."""
    if _device_ok("spectrum_blocks_gram", x):
        return spectrum_blocks_gram_plain(x, sweeps, channels_last)
    _check(x, channels_last)
    full, extra = _schedule_checked(sweeps)
    x, p, c, h, w, lead, n, out = _launch_layout(x, channels_last)
    if p:
        kernels.launch("dctsvd_spectrum_gram_blocks", x.device, x,
                       int(x.dtype == torch.uint8), out, p, c, h, w, full,
                       extra)
        spectrum_blocks_gram.launches += 1
    return out.reshape(*lead, n, B)


def embed_blocks(x: torch.Tensor, sws: torch.Tensor,
                 sweeps=_SWEEPS_DEFAULT, k: int = B, out_u8: bool = False,
                 channels_last: bool = False, variant: str = "delta"):
    """Blocked embed: (marked in the input layout, u8 with ``out_u8`` else
    f32; sc [..., (C,) N, 8]). ``sws`` [Csws, N, 8] = α·mask·Sw.
    ``variant='delta'`` is the V-free rank-k paint (K2); ``'recon'`` is
    the full U·diag(S')·Vᵀ form (K2r), which paints every component (rows
    of ``sws`` beyond k must be zero, as for the JAX package) and has no
    u8 output. The kernel runs on a CUDA tensor, its plain twin on a CPU
    tensor."""
    if variant not in EMBED_VARIANTS:
        raise ValueError(f"unknown embed variant {variant!r}; expected one "
                         f"of {EMBED_VARIANTS}")
    _check_sws(x, sws, channels_last, k)
    if variant == "recon":
        if out_u8:
            raise ValueError("out_u8 requires the delta variant")
        return embed_blocks_recon(x, sws, sweeps, channels_last)
    if _device_ok("embed_blocks", x, sws):
        return embed_blocks_plain(x, sws, sweeps, k, out_u8, channels_last)
    _check(x, channels_last)
    full, extra = _schedule_checked(sweeps)
    x, p, c, h, w, lead, n, sc = _launch_layout(x, channels_last)
    sws = sws.to(torch.float32).contiguous()
    y = torch.empty(x.shape, dtype=torch.uint8 if out_u8 else torch.float32,
                    device=x.device)
    if p:
        kernels.launch("dctsvd_embed_blocks", x.device, x,
                       int(x.dtype == torch.uint8), sws, sws.shape[0], y,
                       int(out_u8), sc, p, c, h, w, full, extra, k)
        embed_blocks.launches += 1
    return y, sc.reshape(*lead, n, B)


def embed_blocks_recon(x: torch.Tensor, sws: torch.Tensor,
                       sweeps=_SWEEPS_DEFAULT, channels_last: bool = False):
    """Full-recon embed: (f32 marked in the input layout, sc). K2r on a
    CUDA tensor, its plain twin on a CPU tensor."""
    _check_sws(x, sws, channels_last, B)
    if _device_ok("embed_blocks_recon", x, sws):
        return embed_blocks_recon_plain(x, sws, sweeps, channels_last)
    _check(x, channels_last)
    full, extra = _schedule_checked(sweeps)
    x, p, c, h, w, lead, n, sc = _launch_layout(x, channels_last)
    if c > RECON_MAX_CHANNELS:
        raise ValueError(f"embed_blocks_recon takes at most "
                         f"{RECON_MAX_CHANNELS} channels a pixel on the "
                         f"GPU, got {c}")
    sws = sws.to(torch.float32).contiguous()
    if sws.data_ptr() % 16:              # the kernel reads float4 rows
        sws = sws.clone()
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if p:
        kernels.launch("dctsvd_embed_recon_blocks", x.device, x,
                       int(x.dtype == torch.uint8), sws, sws.shape[0], y, sc,
                       p, c, h, w, full, extra)
        embed_blocks_recon.launches += 1
    return y, sc.reshape(*lead, n, B)


def roundtrip_frames_blocks(frames: torch.Tensor, sws: torch.Tensor,
                            sweeps=_SWEEPS_DEFAULT, k: int = B):
    """Embed + verification spectrum in one kernel (K3) on block-aligned
    u8 channels-last frames [..., H, W, C]: (stego u8 [..., H, W, C],
    sc [..., C, N, 8], s_cw [..., C, N, 8]). s_cw is the stego's spectrum
    at the same schedule, equal to ``spectrum_blocks(stego,
    channels_last=True)``. The kernel runs on a CUDA tensor, its plain
    twin on a CPU tensor."""
    if frames.dtype != torch.uint8 or frames.ndim < 3:
        raise ValueError("roundtrip_frames_blocks takes u8 channels-last "
                         f"frames [..., H, W, C], got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    _check(frames, True)
    _check_sws(frames, sws, True, k)
    if _device_ok("roundtrip_frames_blocks", frames, sws):
        return roundtrip_frames_blocks_plain(frames, sws, sweeps, k)
    full, extra = _schedule_checked(sweeps)
    x, p, c, h, w, lead, n, sc = _launch_layout(frames, True)
    sws = sws.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    scw = torch.empty_like(sc)
    if p:
        kernels.launch("dctsvd_roundtrip_blocks", x.device, x, sws,
                       sws.shape[0], y, sc, scw, p, c, h, w, full, extra, k)
        roundtrip_frames_blocks.launches += 1
    return y, sc.reshape(*lead, n, B), scw.reshape(*lead, n, B)


spectrum_blocks.launches = 0
spectrum_blocks_gram.launches = 0
embed_blocks.launches = 0
embed_blocks_recon.launches = 0
roundtrip_frames_blocks.launches = 0
