"""SVD entry points (counterpart of ``dctsvd_tpu/ops/svd.py``).

  - :func:`svd_full`: the parity path's whole-frame thin SVD, a library
    call (``torch.linalg.svd``; cuSOLVER on the GPU, LAPACK on the CPU).
  - :func:`jacobi_svd`: the blocked scheme's batched 8×8 SVD. The JAX
    package sends ``[..., 8, 8]`` with ``sort_descending`` to its Pallas
    kernel and everything else to an XLA formulation; the port has only
    the kernel route (K4, ops/svd_cuda.py), and the other shapes, unused
    by the blocked scheme, raise.
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


def jacobi_svd(a: torch.Tensor, sweeps=5, compute_uv: bool = True,
               sort_descending: bool = True):
    """(U [..., 8, 8], S [..., 8], Vt [..., 8, 8]) with S sorted
    descending, or just S when ``compute_uv=False``."""
    if not sort_descending or a.shape[-2:] != (8, 8):
        raise NotImplementedError(
            "jacobi_svd takes [..., 8, 8] with sort_descending=True; got "
            f"{tuple(a.shape)}, sort_descending={sort_descending}")
    return jacobi_svd8(a.to(torch.float32), sweeps=sweeps,
                       compute_uv=compute_uv)
