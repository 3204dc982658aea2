"""Model layer of the port.

`vit.py`       — ViT-B/16 + anti-spoof head and the linear-head ablation
                 as ``nn.Module``s with the published checkpoint's keys
                 and flax's ``dtype`` policy; ``fold_normalization``.
`resnet.py`    — ResNet50 with torchvision's keys, NHWC input.
`convert.py`   — JAX-layout trees and upstream checkpoints (timm, HF,
                 torchvision) -> the port's key sets; reference-format
                 ``.pth`` files; a JAX train state carried across.
`registry.py`  — the four evaluated models, ``build_model`` (files and
                 checkpoint directories), ``build_vit_from_config``.
`fastserve.py` — the bf16 serving path over the hand-written kernels.
`fasttrain.py` — the training forward and its autograd functions over
                 the hand-written kernels.
"""
