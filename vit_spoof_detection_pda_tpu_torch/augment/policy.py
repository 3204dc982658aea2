"""Severity-tier augmentation policies and the differential plan
(counterpart of the JAX package's ``augment/policy.py``; the op
parameters are the reference's three Kornia pipelines).

heavy : HFlip(.5), Rot(20, p.7), CJ(.4,.4,.4,.2, p.8), Blur(5x5, s .1-2, p.5),
        Noise(std .05, p.3), Persp(.2, p.4), Elastic(p.3), Sharp(2.0, p.3)
medium: HFlip(.5), Rot(15, p.6), CJ(.3,.3,.3,.1, p.7), Blur(3x3, s .1-1.5, p.4),
        Noise(.03, p.2), Persp(.15, p.3)
light : HFlip(.5), Rot(10, p.5), CJ(.2,.2,.2,.05, p.5), Blur(3x3, s .1-1, p.3)

The chains work in [0, 1] with the reference's effective on-disk
parameters (it jittered ImageNet-normalized tensors): noise std scaled by
the per-channel ImageNet std, the warp fill at the channel mean, the
brightness / contrast / saturation in the normalized domain, the hue in
the unit domain.  The geometric sub-ops of a tier are one
``ComposedGeometric`` (the gather-free tower of scanline passes, on the
warp kernel on the card); the tiers jitter in the fixed order, the
train-time chain in a per-sample random order.
"""

from __future__ import annotations

from typing import List

from ..ops import augment as A
from ..ops.image import IMAGENET_MEAN, IMAGENET_STD

Chain = List[A.RandomOp]    # each op: (generator, batch [B,H,W,C] in [0,1]) -> batch


def heavy_chain() -> Chain:
    return [
        A.ComposedGeometric(hflip_p=0.5, rotation=(20.0, 0.7),
                            perspective=(0.2, 0.4),
                            elastic=(1.0, 32.0, 63, 0.3), fill=IMAGENET_MEAN),
        A.ColorJitter(0.4, 0.4, 0.4, 0.2, p=0.8, order="fixed",
                      domain="normalized"),
        A.GaussianBlur(5, (0.1, 2.0), p=0.5),
        A.GaussianNoise(std=tuple(0.05 * s for s in IMAGENET_STD), p=0.3),
        A.RandomSharpness(2.0, p=0.3),
    ]


def medium_chain() -> Chain:
    return [
        A.ComposedGeometric(hflip_p=0.5, rotation=(15.0, 0.6),
                            perspective=(0.15, 0.3), fill=IMAGENET_MEAN),
        A.ColorJitter(0.3, 0.3, 0.3, 0.1, p=0.7, order="fixed",
                      domain="normalized"),
        A.GaussianBlur(3, (0.1, 1.5), p=0.4),
        A.GaussianNoise(std=tuple(0.03 * s for s in IMAGENET_STD), p=0.2),
    ]


def light_chain() -> Chain:
    return [
        A.ComposedGeometric(hflip_p=0.5, rotation=(10.0, 0.5),
                            fill=IMAGENET_MEAN),
        A.ColorJitter(0.2, 0.2, 0.2, 0.05, p=0.5, order="fixed",
                      domain="normalized"),
        A.GaussianBlur(3, (0.1, 1.0), p=0.3),
    ]


CHAINS = {"heavy": heavy_chain, "medium": medium_chain, "light": light_chain}


def severity_for_copy(aug_idx: int, num_augmentations: int) -> str:
    """First third heavy, middle third medium, rest light."""
    if aug_idx < num_augmentations // 3:
        return "heavy"
    if aug_idx < 2 * num_augmentations // 3:
        return "medium"
    return "light"


def differential_plan(live_augmentations: int = 8,
                      spoof_augmentations: int = 2):
    """``[(class_name, copy_index, severity), ...]`` of the differential
    fan-out (live x8 / spoof x2)."""
    plan = []
    for cls, n in (("live", live_augmentations),
                   ("spoof", spoof_augmentations)):
        for i in range(n):
            plan.append((cls, i, severity_for_copy(i, n)))
    return plan


def train_time_chain(crop_size=224, hflip_prob: float = 0.5,
                     color_jitter=(0.2, 0.2, 0.2, 0.1),
                     rotation_deg: float = 10.0,
                     random_erase_prob: float = 0.25) -> Chain:
    """The per-batch training augmentation (the reference's torchvision
    train transform): RandomCrop (``None``: inputs already at size) ->
    HFlip -> ColorJitter (random order) -> Rotation -> RandomErasing
    (pre-normalization, value 0: a documented deviation)."""
    b, c, s, h = color_jitter
    chain: Chain = []
    if crop_size is not None:
        chain.append(A.RandomCrop(crop_size))
    chain += [
        A.RandomHFlip(p=hflip_prob),
        A.ColorJitter(b, c, s, h, p=1.0),
        A.ComposedGeometric(rotation=(rotation_deg, 1.0)),
        A.RandomErasing(p=random_erase_prob),
    ]
    return chain


def make_batch_augmenter(level_or_chain):
    """A tier name or a chain -> ``fn(generator, batch [B,H,W,C])``."""
    chain = (CHAINS[level_or_chain]() if isinstance(level_or_chain, str)
             else level_or_chain)

    def run(gen, batch):
        return A.apply_chain(gen, batch, chain)

    return run
