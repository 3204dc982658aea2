"""Tensor ops of the port.

`image.py`     — ImageNet normalization of NHWC images.
`gelu.py`      — erf and tanh GELU, term by term as ``jax.nn.gelu``.
`attention.py` — the attention-block and MLP-block kernels' wrappers,
                 their plain versions and launch counts.
`_build.py`    — nvcc build and ctypes loading of ``csrc/*.cu``.
"""
