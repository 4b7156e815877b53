"""Batched one-sided Jacobi SVD of 8×8 blocks: kernel K4 and its plain twin.

K4 (``csrc/svd8.cu``) replaces the Pallas kernel
``dctsvd_tpu/ops/svd_pallas.py::_make_kernel`` (called through
``jacobi_svd_pallas``). This module also holds the plain PyTorch twin of
the shared Jacobi core K0 (``csrc/jacobi8.cuh``), which the twins of K1
and K2 (ops/wm_cuda.py) reuse:

  - columns g_c of each block (8 values each, batch on the leading dims);
  - Rutishauser-cached column norms, one fresh dot per pair;
  - the 2-rsqrt rotation of :func:`_rotation`;
  - ``full`` cyclic-by-rows sweeps over the 28 pairs, then the first
    ``extra`` pairs of another sweep;
  - fresh final norms, ordered descending by the 19-comparator Batcher
    network, swapping on a strict ``<``.

Every 8-row dot product is reduced in the halving order of
``wm_pallas._sum_rows`` so the twin and the kernel add in the same order.

The wrapper :func:`jacobi_svd8` runs the twin only for CPU tensors; for a
CUDA tensor it launches K4 or raises.
"""

from __future__ import annotations

import torch

from dctsvd_tpu_torch.utils import kernels

B = 8
PAIRS = [(p, q) for p in range(B - 1) for q in range(p + 1, B)]

# Batcher odd-even mergesort network for 8 elements (19 comparators).
_SORT_NET = [(0, 1), (2, 3), (4, 5), (6, 7),
             (0, 2), (1, 3), (4, 6), (5, 7),
             (1, 2), (5, 6),
             (0, 4), (1, 5), (2, 6), (3, 7),
             (2, 4), (3, 5),
             (1, 2), (3, 4), (5, 6)]


def _schedule(sweeps):
    """(full sweeps, extra pairs) of a possibly fractional sweep count:
    ``1.25`` is one full sweep plus the first 7 pairs of a second. Pair
    counts that round up to a whole sweep promote (1.999 -> (2, 0))."""
    full = int(sweeps)
    extra = int(round((float(sweeps) - full) * len(PAIRS)))
    full += extra // len(PAIRS)
    extra %= len(PAIRS)
    return max(0, full), extra


def _sum_rows(v: torch.Tensor) -> torch.Tensor:
    """Σ over the trailing 8-row axis in halving order: [..., 8] -> [...]."""
    t = v[..., 0:4] + v[..., 4:8]
    t = t[..., 0:2] + t[..., 2:4]
    return t[..., 0] + t[..., 1]


def _rotation(app, aqq, apq):
    """Stable Jacobi rotation (c, s, t = s/c) with two rsqrt and no
    division: d = aqq − app, e = 2·apq, ir = rsqrt(d² + e²),
    c² = ½ + ½·|d|·ir, ic = rsqrt(c²), c = c²·ic, s = ±½·e·ir·ic,
    t = s·ic. d = e = 0 gives the identity rotation."""
    d = aqq - app
    e = 2.0 * apq
    h2 = d * d + e * e
    safe = h2 > 0.0
    one = torch.ones_like(h2)
    ir = torch.rsqrt(torch.where(safe, h2, one))
    c2 = 0.5 + 0.5 * torch.abs(d) * ir
    ic = torch.where(safe, torch.rsqrt(c2), one)
    c = torch.where(safe, c2 * ic, one)
    sgn = torch.where(d >= 0, 0.5, -0.5).to(d.dtype)
    s = torch.where(safe, sgn * e * ir * ic, torch.zeros_like(h2))
    t = s * ic
    return c, s, t


def _jacobi8(g: list, full: int, extra: int, v: list | None = None,
             cached: bool = False):
    """K0 twin: rotate the column list ``g`` (8 tensors [..., 8]) and, when
    given, the V columns ``v`` in place; returns the fresh, UNSORTED
    column norms (8 tensors [...]), or with ``cached`` sqrt(max(n, 0)) of
    the Rutishauser-cached norms n (the cached-norms probe)."""
    norms = [_sum_rows(c * c) for c in g]

    def rotate(pairs):
        for p, q in pairs:
            gp, gq = g[p], g[q]
            app, aqq = norms[p], norms[q]
            apq = _sum_rows(gp * gq)
            c, s, t = _rotation(app, aqq, apq)
            norms[p] = app - t * apq
            norms[q] = aqq + t * apq
            c, s = c[..., None], s[..., None]
            g[p] = c * gp - s * gq
            g[q] = s * gp + c * gq
            if v is not None:
                vp, vq = v[p], v[q]
                v[p] = c * vp - s * vq
                v[q] = s * vp + c * vq

    for _ in range(full):
        rotate(PAIRS)
    if extra:
        rotate(PAIRS[:extra])
    if cached:
        return [torch.sqrt(torch.clamp(n, min=0.0)) for n in norms]
    return [torch.sqrt(_sum_rows(c * c)) for c in g]


def _sort8(s: list, *cols: list) -> None:
    """Descending Batcher sort of ``s`` in place, swapping the matching
    entries of every column list in ``cols`` along with it."""
    for i, j in _SORT_NET:
        swap = s[i] < s[j]
        s[i], s[j] = (torch.where(swap, s[j], s[i]),
                      torch.where(swap, s[i], s[j]))
        sw2 = swap[..., None]
        for c in cols:
            c[i], c[j] = (torch.where(sw2, c[j], c[i]),
                          torch.where(sw2, c[i], c[j]))


def jacobi_svd8_plain(a: torch.Tensor, sweeps=5, compute_uv: bool = True):
    """Plain twin of K4 on [..., 8, 8] f32: (U, S, Vt) or S, sorted
    descending."""
    full, extra = _schedule(sweeps)
    g = [a[..., :, c] for c in range(B)]
    if not compute_uv:
        s = _jacobi8(g, full, extra)
        _sort8(s)
        return torch.stack(s, dim=-1)
    eye = torch.eye(B, dtype=a.dtype, device=a.device)
    zeros = torch.zeros_like(a[..., 0, :])
    v = [zeros + eye[i] for i in range(B)]
    s = _jacobi8(g, full, extra, v)
    u = [g[i] / torch.clamp(s[i], min=1e-30)[..., None] for i in range(B)]
    _sort8(s, u, v)
    return (torch.stack(u, dim=-1), torch.stack(s, dim=-1),
            torch.stack(v, dim=-2))


def jacobi_svd8(a: torch.Tensor, sweeps=5, compute_uv: bool = True):
    """Batched 8×8 Jacobi SVD of [..., 8, 8] f32, sorted descending: K4 on
    a CUDA tensor, its plain twin on a CPU tensor."""
    if a.shape[-2:] != (B, B) or a.dtype != torch.float32:
        raise ValueError(f"jacobi_svd8 takes [..., 8, 8] float32, got "
                         f"{tuple(a.shape)} {a.dtype}")
    full, extra = _schedule(sweeps)
    if full == 0 and extra == 0:
        raise ValueError("a 0-sweep schedule returns column norms, not "
                         "singular values")
    if a.device.type == "cpu":
        return jacobi_svd8_plain(a, sweeps, compute_uv)
    if a.device.type != "cuda":
        raise ValueError(f"jacobi_svd8: unsupported device {a.device}")
    lead = a.shape[:-2]
    x = a.contiguous().reshape(-1, B, B)
    if x.data_ptr() % 16:           # K4 reads its blocks as 16-byte pieces
        x = x.clone()
    nb = x.shape[0]
    s = torch.empty(nb, B, dtype=torch.float32, device=a.device)
    u = vt = None
    if compute_uv:
        u = torch.empty_like(x)
        vt = torch.empty_like(x)
    if nb:
        kernels.launch("dctsvd_svd8", a.device, x, u if compute_uv else 0, s,
                       vt if compute_uv else 0, nb, full, extra,
                       int(compute_uv))
        jacobi_svd8.launches += 1
    if not compute_uv:
        return s.reshape(*lead, B)
    return (u.reshape(*lead, B, B), s.reshape(*lead, B),
            vt.reshape(*lead, B, B))


jacobi_svd8.launches = 0
