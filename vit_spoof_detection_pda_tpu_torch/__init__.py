"""PyTorch/CUDA port of ``vit_spoof_detection_pda_tpu`` for the NVIDIA
H100.

Module paths mirror the JAX package so each counterpart is easy to find;
the port imports neither JAX nor the JAX package.  Entry points run on
the CUDA card unless the caller passes ``device="cpu"``, which runs the
plain PyTorch version of every kernel.  The hand-written kernels live in
``csrc/`` and are built with nvcc at first use (``ops/_build.py``).
"""
