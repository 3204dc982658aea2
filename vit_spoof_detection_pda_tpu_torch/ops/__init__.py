"""Tensor ops of the port.

`image.py`     — ImageNet normalization of NHWC images.
`gelu.py`      — erf and tanh GELU, term by term as ``jax.nn.gelu``, and
                 the lean-backward GELU.
`losses.py`    — focal loss, weighted and label-smoothed cross entropy.
`attention.py` — the attention-block, MLP-block and attention-backward
                 kernels' wrappers, their plain versions and launch counts.
`ln_bwd.py`    — the LayerNorm/residual-backward kernel's wrapper.
`_build.py`    — nvcc build and ctypes loading of ``csrc/*.cu``.
"""
