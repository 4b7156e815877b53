"""SVD entry points (counterpart of ``dctsvd_tpu/ops/svd.py``).

  - :func:`svd_full`: the parity path's whole-frame thin SVD, a library
    call (``torch.linalg.svd``; cuSOLVER on the GPU, LAPACK on the CPU).
  - :func:`jacobi_svd`: batched one-sided Jacobi SVD of small
    ``[..., m, n]`` matrices (m >= n, n <= 32). The shape alone picks the
    route: ``[..., 8, 8]`` sorted descending goes to the kernel (K4,
    ops/svd_cuda.py: the blocked scheme's), everything else to the plain
    formulation :func:`_jacobi_svd_plain`, the JAX package's
    ``_jacobi_svd_xla`` in torch ops.
  - :func:`jacobi_singular_values`: its values-only alias.
"""

from __future__ import annotations

import torch

from dctsvd_tpu_torch.ops.svd_cuda import jacobi_svd8

#: The cuSOLVER algorithm of :func:`svd_full` on a CUDA tensor, pinned so
#: that embed, extract and detect always run the same one (torch's default
#: runs gesvdj and falls back to gesvd on its own where gesvdj does not
#: converge). Chosen on an H100 from ``chip_smoke.py``'s ``svd_drivers``
#: phase (PERF.md §6): all three drivers are bit-stable between two runs,
#: but gesvda fails to converge on a rank-deficient (screenshot-like)
#: cover, and gesvdj's S and orthogonality errors are one to two orders
#: of magnitude over gesvd's.
SVD_DRIVER = "gesvd"


def svd_full(x: torch.Tensor, compute_uv: bool = True):
    """Thin SVD (U, S, Vt) of the trailing two axes, batched over the
    leading ones.

    ``compute_uv=False`` still runs the full decomposition and returns S:
    a values-only call (``svdvals``) is a different algorithm whose S
    differs from the full call's, and extract and detect divide
    ``S_stego − Sc`` by alpha, so on an unmodified image that difference
    must be exactly zero against the meta's stored Sc."""
    driver = SVD_DRIVER if x.is_cuda else None
    u, s, vt = torch.linalg.svd(x, full_matrices=False, driver=driver)
    if compute_uv:
        return u, s, vt
    return s


def _rotation(app: torch.Tensor, aqq: torch.Tensor, apq: torch.Tensor):
    """Stable Jacobi rotation (c, s) zeroing the (p, q) entry of the
    implicit Gram matrix (the JAX package's ``svd._rotation``): sign(0) is
    +1, so equal-norm parallel columns rotate by 45 degrees."""
    denom = 2.0 * apq
    safe = torch.abs(denom) > 1e-30
    zeta = torch.where(safe, (aqq - app) / torch.where(safe, denom, 1.0),
                       0.0)
    sgn = torch.where(zeta >= 0, 1.0, -1.0).to(zeta.dtype)
    t = sgn / (torch.abs(zeta) + torch.sqrt(1.0 + zeta * zeta))
    t = torch.where(safe, t, 0.0)
    c = torch.rsqrt(1.0 + t * t)
    return c, c * t


def _jacobi_svd_plain(a: torch.Tensor, sweeps=5, compute_uv: bool = True,
                      sort_descending: bool = True):
    """The JAX package's ``_jacobi_svd_xla`` in torch: columns g[p] [m, B]
    (the batch B flattened), Rutishauser-cached norms (one dot a pair),
    ``full`` cyclic-by-rows sweeps plus the first ``extra`` pairs of
    another for a fractional count, fresh final norms, U = G / S with zero
    columns guarded, then the optional descending sort (stable)."""
    *batch, m, n = a.shape
    if n > m:
        raise ValueError("jacobi_svd requires m >= n (pass a transposed).")
    bsz = 1
    for d in batch:
        bsz *= d
    x = a.reshape(bsz, m, n)
    g = [x[:, :, p].transpose(0, 1) for p in range(n)]        # [m, B]
    v = None
    if compute_uv:
        eye = torch.eye(n, dtype=a.dtype, device=a.device)
        v = [eye[:, p, None].expand(n, bsz) for p in range(n)]
    pairs = [(p, q) for p in range(n - 1) for q in range(p + 1, n)]
    norms = [torch.sum(gp * gp, dim=0) for gp in g]            # [B]

    def rotate(rot_pairs):
        for p, q in rot_pairs:
            gp, gq = g[p], g[q]
            app, aqq = norms[p], norms[q]
            apq = torch.sum(gp * gq, dim=0)
            c, s = _rotation(app, aqq, apq)
            t = s / c
            norms[p] = app - t * apq
            norms[q] = aqq + t * apq
            g[p] = c * gp - s * gq
            g[q] = s * gp + c * gq
            if v is not None:
                vp, vq = v[p], v[q]
                v[p] = c * vp - s * vq
                v[q] = s * vp + c * vq

    full = int(sweeps)
    extra = int(round((float(sweeps) - full) * len(pairs))) if pairs else 0
    if pairs:
        full += extra // len(pairs)
        extra %= len(pairs)
    for _ in range(full):
        rotate(pairs)
    rotate(pairs[:extra])

    s = torch.sqrt(torch.stack([torch.sum(gp * gp, dim=0) for gp in g]))
    s_bn = s.transpose(0, 1).reshape(*batch, n)               # [..., n]
    if not compute_uv:
        if not sort_descending:
            return s_bn
        return torch.sort(s_bn, dim=-1, descending=True).values
    denom = torch.where(s > 1e-30, s, 1.0)                     # [n, B]
    u = torch.stack([gp / denom[p] for p, gp in enumerate(g)], dim=-1)
    u_b = u.permute(1, 0, 2).reshape(*batch, m, n)
    # v[p] is V's column p: stacked as rows, Vt
    vt_b = torch.stack(v, dim=0).permute(2, 0, 1).reshape(*batch, n, n)
    if sort_descending:
        order = torch.argsort(-s_bn, dim=-1, stable=True)
        s_bn = torch.take_along_dim(s_bn, order, dim=-1)
        u_b = torch.take_along_dim(u_b, order[..., None, :], dim=-1)
        vt_b = torch.take_along_dim(vt_b, order[..., :, None], dim=-2)
    return u_b, s_bn, vt_b


def jacobi_svd(a: torch.Tensor, sweeps=5, compute_uv: bool = True,
               sort_descending: bool = True):
    """Batched one-sided Jacobi SVD of [..., m, n] with m >= n small
    (<= 32): (U [..., m, n], S [..., n], Vt [..., n, n]), S >= 0 (sorted
    descending unless ``sort_descending=False``), or just S when
    ``compute_uv=False``. Sorted [..., 8, 8] takes the kernel route (K4 on
    the card, its twin on the CPU), every other call the plain
    formulation."""
    if sort_descending and tuple(a.shape[-2:]) == (8, 8):
        return jacobi_svd8(a.to(torch.float32), sweeps=sweeps,
                           compute_uv=compute_uv)
    return _jacobi_svd_plain(a.to(torch.float32), sweeps=sweeps,
                             compute_uv=compute_uv,
                             sort_descending=sort_descending)


def jacobi_singular_values(a: torch.Tensor, sweeps=5) -> torch.Tensor:
    """Values-only :func:`jacobi_svd` (S sorted descending)."""
    return jacobi_svd(a, sweeps=sweeps, compute_uv=False)
