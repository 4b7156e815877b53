"""Orthonormal DCT-II/III as plain f32 tensor products: the whole-plane
transform of the parity path and the 8×8 block transform of the blocked
scheme.

Counterpart of ``dctsvd_tpu/ops/dct.py``: the basis is built in float64 on
the host and cast once, block tensors keep the ``[..., N, b, b]``
row-major layout (``n = by·Wb + bx``), and every product runs in full f32
(TF32 must stay off on the GPU, see ``chip_smoke.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _dct_matrix_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis: D[k, j] = s_k * cos(pi*(2j+1)*k / (2n)).

    Built in float64 on host and cast once, so the f32 basis carries full
    precision. D is orthogonal: D @ D.T = I.
    """
    j = np.arange(n)[None, :]
    k = np.arange(n)[:, None]
    d = np.cos(np.pi * (2 * j + 1) * k / (2 * n))
    d *= np.sqrt(2.0 / n)
    d[0] *= np.sqrt(0.5)
    return d


@functools.lru_cache(maxsize=64)
def _constant(build, args: tuple, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(build(*args), dtype=dtype, device=device)


def host_constant(build, *args, device, dtype=torch.float32) -> torch.Tensor:
    """``build(*args)`` (a host array) as a tensor on ``device``, copied
    once per (array, device, dtype): a copy from the host blocks until the
    card's queue drains, so per-call copies would serialise the shards of
    a batch. The tensor is shared: callers must not write to it."""
    return _constant(build, args, torch.device(device), dtype)


def dct_matrix(n: int, device, dtype=torch.float32) -> torch.Tensor:
    return host_constant(_dct_matrix_np, n, device=device, dtype=dtype)


@functools.lru_cache(maxsize=16)
def _dct_kron_np(b: int) -> np.ndarray:
    """F[k, l, i, j] = D[k, i] · D[l, j] (f64 host build)."""
    d = _dct_matrix_np(b)
    return np.einsum("ki,lj->klij", d, d)


def blockify(x: torch.Tensor, b: int = 8) -> torch.Tensor:
    """[..., H, W] -> [..., H//b * W//b, b, b] row-major block tensor.

    H and W must be multiples of b (callers pad first; models/blocked.py).
    """
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // b, b, w // b, b).transpose(-3, -2)
    return x.reshape(*lead, (h // b) * (w // b), b, b)


def unblockify(blocks: torch.Tensor, h: int, w: int,
               b: int = 8) -> torch.Tensor:
    """Inverse of :func:`blockify`."""
    lead = blocks.shape[:-3]
    x = blocks.reshape(*lead, h // b, w // b, b, b).transpose(-3, -2)
    return x.reshape(*lead, h, w)


def unblockify_to_frames(blocks: torch.Tensor, hp: int,
                         wp: int) -> torch.Tensor:
    """[..., C, N, 8, 8] pixel blocks -> [..., H, W, C] frames in one
    permute (unblockify with the channel move folded in)."""
    *lead, c, _, b, _ = blocks.shape
    hb, wb = hp // b, wp // b
    x = blocks.reshape(*lead, c, hb, wb, b, b)
    nd = x.ndim
    perm = (*range(nd - 5), nd - 4, nd - 2, nd - 3, nd - 1, nd - 5)
    return x.permute(perm).reshape(*lead, hp, wp, c)


def dct2_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Batched b×b DCT over a [..., N, b, b] block tensor: D·X·Dᵀ."""
    d = dct_matrix(blocks.shape[-1], blocks.device, blocks.dtype)
    return torch.einsum("ki,...nij,lj->...nkl", d, blocks, d)


def idct2_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Batched b×b inverse DCT over a [..., N, b, b] coefficient tensor:
    Dᵀ·C·D."""
    d = dct_matrix(blocks.shape[-1], blocks.device, blocks.dtype)
    return torch.einsum("ik,...nij,jl->...nkl", d, blocks, d)


def dct2_plane_blocks(x: torch.Tensor, b: int = 8) -> torch.Tensor:
    """[..., H, W] plane -> [..., N, b, b] block-DCT coefficients, equal to
    ``dct2_blocks(blockify(x))`` in one contraction with the Kronecker
    basis F[k, l, i, j] = D[k, i]·D[l, j]. H and W must be multiples of
    b (callers pad first)."""
    *lead, h, w = x.shape
    v = x.reshape(*lead, h // b, b, w // b, b)
    f = host_constant(_dct_kron_np, b, device=x.device, dtype=x.dtype)
    out = torch.einsum("...hiwj,klij->...hwkl", v, f)
    return out.reshape(*lead, (h // b) * (w // b), b, b)


def _idct_t_np(b: int) -> np.ndarray:
    """T[p=(i,j), q=(a,c)] = D[a,i]·D[c,j]  (y = Dᵀ X D), f64 [b·b, b·b]."""
    return _dct_kron_np(b).transpose(2, 3, 0, 1).reshape(b * b, b * b)


def idct_pixel_tensor(b: int = 8, row_perm: torch.Tensor | None = None,
                      device=None, dtype=torch.float32) -> torch.Tensor:
    """T[i, j, a, c] with IDCT_block[i, j] = Σ T[i,j,a,c]·coef[a,c], with
    the optional intra-block unshuffle folded in (pixel p of the output
    block = plain-IDCT pixel ``row_perm[p]``)."""
    if row_perm is not None:
        device = row_perm.device
    t = host_constant(_idct_t_np, b, device=device, dtype=dtype)
    if row_perm is not None:
        t = t.index_select(0, row_perm)
    return t.reshape(b, b, b, b)


def idct2_blocks_to_plane(blocks: torch.Tensor, h: int, w: int, b: int = 8,
                          row_perm: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """[..., N, b, b] coefficient blocks -> [..., H, W] spatial plane, with
    the shared intra-block unshuffle ``row_perm`` folded into the basis."""
    t = idct_pixel_tensor(b, row_perm, device=blocks.device,
                          dtype=blocks.dtype)
    lead = blocks.shape[:-3]
    v = blocks.reshape(*lead, h // b, w // b, b, b)
    out = torch.einsum("...hwac,ijac->...hiwj", v, t)
    return out.reshape(*lead, h, w)


def idct2_pixel_blocks(blocks: torch.Tensor, h: int, w: int, b: int = 8,
                       row_perm: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """[..., N, b, b] coefficient blocks -> their [..., N, b·b] pixel blocks
    in natural block order (row-major pixels), the product of
    :func:`idct2_blocks_to_plane` with its output left in block order: the
    same contraction ("...hwac,ijac->...hwij"), whose values are the
    plane's pixel for pixel."""
    t = idct_pixel_tensor(b, row_perm, device=blocks.device,
                          dtype=blocks.dtype)
    lead = blocks.shape[:-3]
    v = blocks.reshape(*lead, h // b, w // b, b, b)
    out = torch.einsum("...hwac,ijac->...hwij", v, t)
    return out.reshape(*lead, (h // b) * (w // b), b * b)


def dct2(x: torch.Tensor) -> torch.Tensor:
    """Whole-plane 2-D DCT-II of the trailing two axes (any leading batch):
    D_H · X · D_Wᵀ, two f32 products (equivalent to cv2.dct per plane)."""
    h, w = x.shape[-2], x.shape[-1]
    dh = dct_matrix(h, x.device, x.dtype)
    dw = dct_matrix(w, x.device, x.dtype)
    return torch.matmul(torch.matmul(dh, x), dw.T)


def idct2(x: torch.Tensor) -> torch.Tensor:
    """Inverse (DCT-III) of :func:`dct2`: D_Hᵀ · X · D_W."""
    h, w = x.shape[-2], x.shape[-1]
    dh = dct_matrix(h, x.device, x.dtype)
    dw = dct_matrix(w, x.device, x.dtype)
    return torch.matmul(torch.matmul(dh.T, x), dw)
