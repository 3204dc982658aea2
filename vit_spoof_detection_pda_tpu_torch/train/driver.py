"""The training data path's augmentation pieces (counterpart of part of the
JAX package's ``train/driver.py``).

``make_prep_fn`` is the step's ``batch_prep``: uint8 -> [0, 1] in the
augmentation dtype -> the chain -> ImageNet-normalized f32, inside the
train step.  The config tree is not ported yet, so these take the JAX
package's ``TrainAugConfig`` / ``AugmentConfig`` fields as keyword
arguments with its defaults; ``Trainer`` and ``train_from_config`` come
with the training loop.
"""

from __future__ import annotations

import torch

from ..augment.policy import CHAINS, train_time_chain
from ..ops import augment as A
from ..ops import image as I

# TrainAugConfig's defaults (the JAX package's config.py)
TRAIN_AUG = dict(crop_size=224, hflip_prob=0.5,
                 color_jitter=(0.2, 0.2, 0.2, 0.1), rotation_deg=10.0,
                 random_erase_prob=0.25)


def _aug_dtype(aug_dtype: str) -> torch.dtype:
    return torch.float32 if aug_dtype == "float32" else torch.bfloat16


def make_prep_fn(chain, *, aug_dtype: str = "bfloat16"):
    """``prep(generator, uint8 [B, S, S, 3]) -> normalized f32``: the chain
    computes in ``aug_dtype`` (bf16 by default); normalization and the
    output are f32."""
    dtype = _aug_dtype(aug_dtype)

    def prep(gen, batch_u8):
        x = I.to_float(batch_u8).to(dtype)
        x = A.apply_chain(gen, x, chain)
        return I.normalize(x.float())

    return prep


def _train_chain(*, crop: bool = True, **train_aug):
    """The torchvision train-time chain from the ``TrainAugConfig``
    fields (``crop=False``: inputs already at size)."""
    ta = {**TRAIN_AUG, **train_aug}
    return train_time_chain(
        crop_size=ta["crop_size"] if crop else None,
        hflip_prob=ta["hflip_prob"], color_jitter=ta["color_jitter"],
        rotation_deg=ta["rotation_deg"],
        random_erase_prob=ta["random_erase_prob"])


def make_train_aug_fn(*, aug_dtype: str = "bfloat16", **train_aug):
    """uint8 ``[B, 256, 256, 3]`` -> augmented normalized f32 ``[B, 224,
    224, 3]`` (the standalone form of the prep of the default chain)."""
    return make_prep_fn(_train_chain(**train_aug), aug_dtype=aug_dtype)


def make_eval_prep_fn():
    """uint8 -> normalized f32, no augmentation."""
    def run(batch_u8):
        return I.normalize(I.to_float(batch_u8)).float()

    return run


def group_chains(*, enabled: bool = True, **train_aug) -> dict:
    """The online and pool modes' chain per severity group: originals get
    the train-time chain without the crop (inputs are already at size),
    each tier its chain plus the same train-time ops (the reference
    re-randomizes its stored copies every epoch)."""
    orig = _train_chain(crop=False, **train_aug) if enabled else []
    chains = {"orig": orig}
    for g in ("heavy", "medium", "light"):
        chains[g] = CHAINS[g]() + orig
    return chains


def make_group_preps(*, aug_dtype: str = "bfloat16", enabled: bool = True,
                     **train_aug) -> dict:
    """``{group: batch_prep}`` over :func:`group_chains`."""
    return {g: make_prep_fn(chain, aug_dtype=aug_dtype)
            for g, chain in group_chains(enabled=enabled,
                                         **train_aug).items()}
