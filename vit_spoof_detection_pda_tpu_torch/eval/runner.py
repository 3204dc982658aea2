"""Batched inference over a dataset (counterpart of the JAX package's
``eval/runner.py``, without a mesh).

Host threads decode (``data/loader.py::DataPipeline``); per batch the
device runs normalize -> the module's forward -> P(live), and only the
score vector comes back.  The tail batch is padded to the batch size, as
the JAX runner pads it to its compiled shape.  One batch stays in
flight: batch i is launched, then batch i-1's scores are fetched (their
copy to the host was queued right after their forward), so the card
never waits on the host's fetch.

The module holds its weights (a port ``nn.Module`` from
``models/registry.py::build_model`` or loaded through
``models/convert.py``); batches go to the device its parameters are on.
On the card the ViT's attention core is kernel 8 (``ops/attention.py::
dispatch_attention_qkv``); on the CPU its plain version.
"""

from __future__ import annotations

import logging
from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..data.loader import DataPipeline
from ..data.manifest import Record
from ..device import exact_f32_matmul
from ..ops import image as I

log = logging.getLogger(__name__)


def module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def make_infer_fn(module, *, normalize: bool = True,
                  input_dtype=torch.float32, threshold: float = 0.5,
                  temperature: Optional[float] = None):
    """``infer(batch) -> {"prob1", "pred"}`` (tensors on the module's
    device): uint8 batches take the fused one-pass normalize, float
    batches in [0, 1] the to_float + normalize path, both in
    ``input_dtype``; then the module (eval mode, no autograd, TF32 off)
    and P(live) = softmax column 1.

    ``threshold``: ``pred`` is P(live) > threshold; the default 0.5 is
    the argmax of the logits, the reference's rule.  ``temperature``:
    P(live) = sigmoid((l1 - l0) / T), and ``pred`` cuts that."""
    if temperature is not None and float(temperature) <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    dev = module_device(module)
    module.eval()

    @torch.inference_mode()
    def infer(batch):
        batch = torch.as_tensor(batch).to(dev)
        with exact_f32_matmul():
            return infer_body(module, batch, normalize=normalize,
                              input_dtype=input_dtype, threshold=threshold,
                              temperature=temperature)

    return infer


def infer_body(forward, batch: torch.Tensor, *, normalize: bool = True,
               input_dtype=torch.float32, threshold: float = 0.5,
               temperature: Optional[float] = None) -> dict:
    """The scoring program of :func:`make_infer_fn` on a batch already on
    the device: normalize, ``forward`` (the module, or a call of it on
    other weights), P(live) and ``pred``.  The frozen module-mode
    artifact (``models/artifact.py``) traces this same function."""
    if not normalize:
        x = I.to_float(batch)
    elif batch.dtype == torch.uint8:
        x = I.normalize_u8_fused(batch, dtype=input_dtype)
    else:
        x = I.normalize(I.to_float(batch)).to(input_dtype)
    logits = forward(x)
    if temperature is not None:
        margin = (logits[:, 1] - logits[:, 0]).float()
        prob1 = torch.sigmoid(margin / float(temperature))
    else:
        prob1 = torch.softmax(logits.float(), dim=-1)[:, 1]
    if threshold == 0.5 and temperature is None:
        pred = logits.argmax(-1).to(torch.int32)
    else:
        pred = (prob1 > threshold).to(torch.int32)
    return {"prob1": prob1, "pred": pred}


def make_fastserve_infer(module, *, device=None):
    """Throughput eval on the serving path (``models/fastserve.py``: bf16,
    tanh GELU, each encoder layer on the attention- and MLP-block
    kernels, the normalization folded into the patch embed, raw uint8
    in): ``infer(batch_u8) -> {"prob1", "pred"}`` with ``pred`` =
    P(live) > 0.5.  Numerics are the serving policy, hence opt-in.  Takes
    the port's ``ViTAntiSpoof``; the linear-head serving forward is not
    ported yet (ROADMAP Queue 1 item 0)."""
    from ..models import fastserve
    from ..models.vit import ViTAntiSpoof

    if not isinstance(module, ViTAntiSpoof):
        raise TypeError("fastserve eval runs the anti-spoof head (the "
                        "linear-head serving forward is ROADMAP Queue 1 "
                        f"item 0); got {type(module).__name__}")
    device = module_device(module) if device is None else device
    weights, raw, kw = fastserve.serving_program(module, mode="fastserve",
                                                 device=device)

    def infer(batch_u8):
        score = raw(weights, torch.as_tensor(batch_u8), **kw).float()
        return {"prob1": score, "pred": (score > 0.5).to(torch.int32)}

    return infer


def _start_fetch(out: dict):
    """Queue the copy of one batch's results to the host; returns the
    host tensors and an event that marks their arrival (None on the
    CPU)."""
    host = {k: v.to("cpu", non_blocking=True) for k, v in out.items()}
    event = None
    if out["prob1"].is_cuda:
        event = torch.cuda.Event()
        event.record()
    return host, event


def score_batches(infer, batches: Iterable[dict], n: int, *,
                  batch_size: int, device) -> tuple:
    """The scoring loop: ``batches`` yields ``{"image": uint8 [b, S, S,
    3], "index": int [b]}`` (numpy or tensors), ``b <= batch_size``;
    each is padded to ``batch_size``, uploaded (from pinned memory on the
    card), scored, and its ``prob1`` / ``pred`` written at its indices of
    two length-``n`` arrays, which are returned.  Batch i-1's results are
    collected after batch i is launched."""
    prob1 = np.zeros(n, np.float32)
    pred = np.zeros(n, np.int32)
    device = torch.device(device)

    def collect(pending):
        (host, event), idx, b = pending
        if event is not None:
            event.synchronize()
        prob1[idx] = host["prob1"][:b].numpy()
        pred[idx] = host["pred"][:b].numpy()

    pending = None
    for batch in batches:
        imgs, idx = torch.as_tensor(batch["image"]), np.asarray(batch["index"])
        b = imgs.shape[0]
        if b < batch_size:                 # pad the tail to the batch size
            imgs = torch.cat([imgs, imgs.new_zeros(
                (batch_size - b,) + tuple(imgs.shape[1:]))])
        if device.type == "cuda" and imgs.device.type == "cpu":
            imgs = imgs.pin_memory()
        out = infer(imgs.to(device, non_blocking=True))
        fetch = _start_fetch(out)
        if pending is not None:
            collect(pending)
        pending = (fetch, idx, b)
    if pending is not None:
        collect(pending)
    return prob1, pred


def run_inference(module, records: Sequence[Record], *,
                  batch_size: int = 128, img_size: int = 224,
                  num_workers: int = 8, normalize: bool = True,
                  fastserve: bool = False, mesh=None) -> dict:
    """``{"labels", "prob1", "pred"}`` per image, aligned with
    ``records`` (labels canonical 1 = live, prob1 = P(live)).

    ``fastserve=True`` scores on the serving path (bf16 kernel numerics,
    opt-in throughput mode; :func:`make_fastserve_infer`).  A device
    mesh comes with slice 6 and raises."""
    if mesh is not None:
        raise NotImplementedError("eval on a device mesh comes with slice 6 "
                                  "(ROADMAP Queue 1 item 9)")
    if fastserve and not normalize:
        raise ValueError("fastserve always folds normalization into the "
                         "weights; normalize=False is only supported on "
                         "the standard path")
    pipe = DataPipeline(records, batch_size=batch_size, img_size=img_size,
                        resize="exact", num_workers=num_workers,
                        shuffle=False, drop_last=False)
    infer = (make_fastserve_infer(module) if fastserve
             else make_infer_fn(module, normalize=normalize))
    prob1, pred = score_batches(infer, pipe.batches(), len(records),
                                batch_size=batch_size,
                                device=module_device(module))
    labels = np.asarray([r.label for r in records], np.int32)
    return {"labels": labels, "prob1": prob1, "pred": pred}
