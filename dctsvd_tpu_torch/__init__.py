"""dctsvd_tpu_torch — the DCT–SVD watermarking system on PyTorch + CUDA.

The port of ``dctsvd_tpu`` (JAX on a TPU) to an NVIDIA H100. It carries
the image API: the parity path (whole-frame DCT + SVD, ``method='full'``)
and the blocked (8×8) scheme — embed, extract and detect, gray and color,
the enhancement chain, text/JSON payloads, detect resync and the serve
steps — and video (``models/video.py``: both schemes, text watermarks,
resume and the audio remux; the CLI's ``video-*`` subcommands), the
multi-device layer (``parallel/``: frame batches over a mesh of devices,
8K frames in horizontal bands), the tkinter GUI (``gui.py``) and the
graft entry points (``graft_entry.py``), with the blocked scheme's
Jacobi kernels written by hand in CUDA C++ for
``sm_90a`` (``csrc/``; K1 spectrum, K2 embed, K3 embed + verify,
K4 8×8 SVD, K2r, K1g), and the measurement probes of the JAX package's
``tools/`` (``tools/``, kernels in ``csrc/probes.cu``), each kernel with a
plain PyTorch twin that runs for CPU tensors. It imports ``torch`` and
never ``jax``; metas are interchangeable with the JAX package's.
"""

__version__ = "0.1.0"

from dctsvd_tpu_torch.api import (embed, extract, detect,  # noqa: E402,F401
                                  embed_payload, extract_payload, OPEN_MODE)
