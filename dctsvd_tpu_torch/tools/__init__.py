"""The measurement probes of the JAX package's ``tools/`` (T1–T6) on the
GPU, one module of the same name each. Every ``main()`` runs its probe's
rows on the card at the probe's own size (1080×1920, batch 32: 96 planes)
and prints one JSON line per row with the card's name and power limit:

    python -m dctsvd_tpu_torch.tools.exp_relayout       # T1
    python -m dctsvd_tpu_torch.tools.profile_transpose  # T2
    python -m dctsvd_tpu_torch.tools.exp_vpu_roofline   # T3
    python -m dctsvd_tpu_torch.tools.exp_widen          # T4
    python -m dctsvd_tpu_torch.tools.exp_cachednorms    # T5
    python -m dctsvd_tpu_torch.tools.profile_view       # T6

Their kernels are in ``ops/probe_cuda.py``.
"""
