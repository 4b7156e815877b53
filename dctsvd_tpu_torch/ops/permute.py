"""Keyed (un)permutation as gathers (counterpart of
``dctsvd_tpu/ops/permute.py``). The index arrays come from the host
(utils/crypto.permutation_indices and block_permutation_indices, NumPy
PCG64)."""

from __future__ import annotations

import torch


def permute_plane(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """scrambled = flat[idx], reshaped back; the trailing two axes are
    H, W (the parity path's whole-plane shuffle)."""
    *lead, h, w = img.shape
    flat = img.reshape(*lead, h * w)
    return flat.index_select(-1, idx).reshape(*lead, h, w)


def unpermute_plane(img: torch.Tensor, inv_idx: torch.Tensor) -> torch.Tensor:
    """restored = scrambled_flat[inv]; pass inv =
    crypto.inverse_permutation(idx)."""
    return permute_plane(img, inv_idx)


def permute_block_tensor(blocks: torch.Tensor, blk_idx: torch.Tensor,
                         intra_idx: torch.Tensor) -> torch.Tensor:
    """Keyed block-level shuffle of a [..., N, b, b] tensor: block slot i
    takes source block ``blk_idx[i]``, and every block's b·b pixels are
    shuffled by the shared ``intra_idx``."""
    *lead, n, b, _ = blocks.shape
    flat = blocks.reshape(*lead, n, b * b)
    flat = flat.index_select(-2, blk_idx)
    flat = flat.index_select(-1, intra_idx)
    return flat.reshape(*lead, n, b, b)
