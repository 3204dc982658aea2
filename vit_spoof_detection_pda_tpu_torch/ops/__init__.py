"""Tensor ops of the port.

`image.py`     — normalization, the jax.image.resize weights, the eval
                 preprocessing.
`gelu.py`      — erf and tanh GELU, term by term as ``jax.nn.gelu``, and
                 the lean-backward GELU.
`losses.py`    — focal loss, weighted and label-smoothed cross entropy.
`attention.py` — the attention-block, MLP-block, attention-backward,
                 fused-QKV and generic q/k/v attention kernels'
                 wrappers, the sequence-parallel attention kernels'
                 (forward and backward), their plain versions and launch
                 counts; ``dispatch_attention_qkv`` and
                 ``attention_sharding``; the serving kernels as
                 ``vsd::`` operators.
`ln_bwd.py`    — the LayerNorm/residual-backward kernel's wrapper.
`lowlat.py`    — the whole-encoder kernels' wrappers, packs (bf16 and
                 int8) and ``vsd::`` operators.
`warp.py`      — the warp-pass kernel's wrapper and the tower's warps.
`augment.py`   — the per-sample random augmentation ops.
`gather.py`    — the pool-gather kernel's wrapper.
`nlm.py`       — the fast-NLM kernel's wrapper.
`_build.py`    — nvcc build and ctypes loading of ``csrc/*.cu``.
"""
