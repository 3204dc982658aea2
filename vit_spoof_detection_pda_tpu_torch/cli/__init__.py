"""The port's command line (counterpart of the JAX package's ``cli/``):
``python -m vit_spoof_detection_pda_tpu_torch <verb> ...`` with the JAX
CLI's verbs, flags and config tree (``--preset``, ``--config <json>``,
repeated ``--set dotted.path=value``, ``PAD_*`` environment overrides):

    python -m vit_spoof_detection_pda_tpu_torch train --preset advanced-train \\
        --set optim.learning_rate=1e-5 --set data.data_root=/data/aug

Verbs run on the CUDA card; ``--device cpu`` (or ``--interpret``, where
the JAX verb has it) runs the kernels' plain PyTorch versions instead.
Without a card and without ``--device cpu`` a verb that computes exits
before it loads a model or data.
"""
