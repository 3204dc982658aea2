"""Model layer of the port.

`vit.py`       — ViT-B/16 + anti-spoof head as ``nn.Module``s with the
                 published checkpoint's keys; ``fold_normalization``.
`convert.py`   — JAX-layout parameter tree <-> checkpoint state dict.
`fastserve.py` — the bf16 serving path over the hand-written kernels.
`fasttrain.py` — the training forward and its autograd functions over
                 the hand-written kernels.
"""
