"""T2: what the [.., 8row, Wb, 8col] -> [.., 8row, 8col, Wb] relayout (the
cols view) costs on the card (the port of ``tools/profile_transpose.py``).

Rows t1–t4 are the JAX tool's XLA transposes, here the PyTorch
expressions, each forced through the hand-written copy kernel
(``copy_consumer``) as the tool forces them through its Pallas copy:

  t1  ``reshape(p, hb, 8, wb, 8).transpose(3, 4).contiguous()``
  t2  the 3-D form: ``reshape(p·hb·8, wb, 8).transpose(1, 2)``
  t3  the identity einsum ``phrwc,ck->phrkw`` (TF32 off)
  t4  the u8 transpose, then ``.float()``
  t5  the hand-written cols-view kernel alone. The JAX kernel ``gatherk``
      computes ``swapaxes(x.reshape(r, 8, Wb, 8), -1, -2)``, which is the
      cols view; its comment's interleaved lane permutation is not what
      its body does, and is not ported.

A ``copy`` row times the consumer alone on the planes, so a relayout's
own cost is its row less that one. The JAX tool adds a mean of each
result to force it; PyTorch runs eagerly, so no row has one. Every row's
result is checked equal to the plain cols view.

    python -m dctsvd_tpu_torch.tools.profile_transpose
"""

from __future__ import annotations

import torch

from dctsvd_tpu_torch.ops import probe_cuda
from dctsvd_tpu_torch.tools import common


def copy_consumer(v: torch.Tensor) -> torch.Tensor:
    """Force ``v`` through the copy kernel."""
    return probe_cuda.copy_f32(v)


def t1(chans: torch.Tensor) -> torch.Tensor:
    p, h, w = chans.shape
    v = chans.reshape(p, h // 8, 8, w // 8, 8).transpose(3, 4).contiguous()
    return copy_consumer(v)


def t2(chans: torch.Tensor) -> torch.Tensor:
    p, h, w = chans.shape
    x = chans.reshape(p * h, w // 8, 8)
    v = x.transpose(1, 2).contiguous().reshape(p, h // 8, 8, 8, w // 8)
    return copy_consumer(v)


def t3(chans: torch.Tensor) -> torch.Tensor:
    p, h, w = chans.shape
    eye = torch.eye(8, dtype=torch.float32, device=chans.device)
    x = chans.reshape(p, h // 8, 8, w // 8, 8)
    return copy_consumer(torch.einsum("phrwc,ck->phrkw", x, eye)
                         .contiguous())


def t4(chans_u8: torch.Tensor) -> torch.Tensor:
    p, h, w = chans_u8.shape
    x = chans_u8.reshape(p, h // 8, 8, w // 8, 8)
    return copy_consumer(x.transpose(3, 4).contiguous().float())


def t5(chans: torch.Tensor) -> torch.Tensor:
    return probe_cuda.cols_view(chans)


def main() -> list:
    dev = common.require_cuda()
    card = common.card_line()
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (common.PLANES, common.H, common.W)
    chans = torch.randn(shape, generator=gen, device=dev)
    chans_u8 = torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.uint8)
    want = probe_cuda.cols_view_plain(chans)
    want_u8 = probe_cuda.cols_view_plain(chans_u8, torch.float32)
    ms = common.cuda_ms(lambda: copy_consumer(chans))
    rows = [common.emit(
        "T2", "copy alone (copy_consumer on the planes)", card,
        shape=list(shape),
        equals_input=bool(torch.equal(copy_consumer(chans), chans)), ms=ms,
        **common.gbps(2 * chans.numel() * 4, ms))]
    for name, fn, x, ref in (
            ("t1 swapaxes + copy f32", t1, chans, want),
            ("t2 3-D transpose + copy f32", t2, chans, want),
            ("t3 einsum-identity + copy f32", t3, chans, want),
            ("t4 u8 transpose + float + copy", t4, chans_u8, want_u8),
            ("t5 cols-view kernel f32", t5, chans, want)):
        ms = common.cuda_ms(lambda fn=fn, x=x: fn(x))
        rows.append(common.emit(
            "T2", name, card, shape=list(shape),
            equals_cols_view=bool(torch.equal(fn(x), ref)), ms=ms,
            **common.gbps(x.numel() * x.element_size() + ref.numel() * 4,
                          ms)))
    return rows


if __name__ == "__main__":
    main()
