"""Batched inference over a dataset (counterpart of the JAX package's
``eval/runner.py``).

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
dispatch_attention_qkv``); on the CPU its plain version.  Under a mesh
(one process per rank) each data rank scores its share of the records
(on the fastserve path its block of each global batch) and the scores
are gathered back into record order.  Under a model axis the module path
head-shards (each rank its Megatron slices of the weights,
``parallel/mesh.py::module_tp_state``); fastserve replicates the weights
and shards the batch over the data axis only, as JAX's
``serving_forward_sharded`` does.
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
from ..ops.attention import attention_sharding
from ..utils.profiling import annotate

log = logging.getLogger(__name__)


def module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def make_infer_fn(module, *, normalize: bool = True,
                  input_dtype=torch.float32, threshold: float = 0.5,
                  temperature: Optional[float] = None, mesh=None):
    """``infer(batch) -> {"prob1", "pred"}`` (tensors on the module's
    device): uint8 batches take the fused one-pass normalize, float
    batches in [0, 1] the to_float + normalize path, both in
    ``input_dtype``; then the module (eval mode, no autograd, TF32 off)
    and P(live) = softmax column 1.

    ``threshold``: ``pred`` is P(live) > threshold; the default 0.5 is
    the argmax of the logits, the reference's rule.  ``temperature``:
    P(live) = sigmoid((l1 - l0) / T), and ``pred`` cuts that.  ``mesh``:
    the forward runs under ``attention_sharding(mesh)`` on this rank's
    rows; with a model axis larger than 1 on this rank's Megatron slices
    of the module's weights (the attention on its heads)."""
    if temperature is not None and float(temperature) <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    dev = module_device(module)
    module.eval()
    forward = module
    from ..parallel.mesh import MODEL_AXIS, axis_sizes, module_tp_state
    if mesh is not None and axis_sizes(mesh).get(MODEL_AXIS, 1) > 1:
        local = module_tp_state(module, mesh)

        def forward(x):
            return torch.func.functional_call(module, local, (x,))

    @torch.inference_mode()
    def infer(batch):
        batch = torch.as_tensor(batch).to(dev)
        with exact_f32_matmul(), attention_sharding(mesh):
            return infer_body(forward, batch, normalize=normalize,
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


def make_fastserve_infer(module, *, device=None, mesh=None):
    """Throughput eval on the serving path (``models/fastserve.py``: bf16,
    tanh GELU, each encoder layer on the attention- and MLP-block
    kernels, the normalization folded into the patch embed, raw uint8
    in): ``infer(batch_u8) -> {"prob1", "pred"}`` with ``pred`` =
    P(live) > 0.5.  Numerics are the serving policy, hence opt-in.  Takes
    the port's ``ViTAntiSpoof`` (P(live) = sigmoid(l1 - l0)) and
    ``ViTLinearHead`` (the "Base ViT" ablation: softmax column 1), which
    ride the same trunk; any other module raises ``TypeError``.  With a
    ``mesh`` of more than one rank (JAX :130-137) each call takes the
    global batch and scores it through ``serving_forward_sharded``: each
    data rank its block (the ranks along a model axis the same block, the
    weights replicated), the scores gathered in batch order."""
    from ..models import fastserve
    from ..models.convert import vit_linear_from_torch
    from ..models.vit import ViTAntiSpoof, ViTLinearHead, fold_normalization

    device = module_device(module) if device is None else device
    with annotate("vsd.build.serving"):
        if isinstance(module, ViTAntiSpoof):
            weights, raw, kw = fastserve.serving_program(
                module, mode="fastserve", device=device)
        elif isinstance(module, ViTLinearHead):
            folded = fold_normalization(vit_linear_from_torch(
                module.state_dict()))["params"]
            weights = fastserve.prepare_params(
                folded, dtype=torch.bfloat16, device=device)
            raw = fastserve.serving_forward_linear
            kw = dict(num_heads=module.num_heads,
                      patch_size=module.patch_size, depth=module.depth,
                      norm_eps=module.norm_eps, dtype=torch.bfloat16,
                      device=device)
        else:
            raise TypeError("fastserve eval supports ViTAntiSpoof and "
                            f"ViTLinearHead; got {type(module).__name__}")
    sharded = mesh is not None and mesh.mesh.numel() > 1

    def infer(batch_u8):
        batch_u8 = torch.as_tensor(batch_u8)
        out = (fastserve.serving_forward_sharded(weights, batch_u8, mesh,
                                                 fn=raw, **kw)
               if sharded else raw(weights, batch_u8, **kw))
        score = (out if out.ndim == 1 else out[:, 1]).float()
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
    collected after batch i is launched.  Each batch opens the spans
    ``vsd.eval.upload`` (pad, pin, copy to the device),
    ``vsd.eval.forward`` (``infer`` and the queued fetch) and
    ``vsd.eval.collect`` (the wait for its results, their copy into the
    arrays)."""
    prob1 = np.zeros(n, np.float32)
    pred = np.zeros(n, np.int32)
    device = torch.device(device)

    def collect(pending):
        (host, event), idx, b = pending
        with annotate("vsd.eval.collect"):
            if event is not None:
                event.synchronize()
            prob1[idx] = host["prob1"][:b].numpy()
            pred[idx] = host["pred"][:b].numpy()

    pending = None
    for batch in batches:
        with annotate("vsd.eval.upload"):
            imgs = torch.as_tensor(batch["image"])
            idx = np.asarray(batch["index"])
            b = imgs.shape[0]
            if b < batch_size:             # pad the tail to the batch size
                imgs = torch.cat([imgs, imgs.new_zeros(
                    (batch_size - b,) + tuple(imgs.shape[1:]))])
            if device.type == "cuda" and imgs.device.type == "cpu":
                imgs = imgs.pin_memory()
            x = imgs.to(device, non_blocking=True)
        with annotate("vsd.eval.forward"):
            fetch = _start_fetch(infer(x))
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
    opt-in throughput mode; :func:`make_fastserve_infer`).

    ``mesh`` (JAX :147-175): data-parallel scoring.  ``batch_size`` is the
    global batch and must divide by the data axis, and every rank returns
    all the scores in record order.  On the module path data rank r
    scores the records ``r, r + n, ...`` at ``batch_size / n`` a batch
    (the ranks of one sequence group alike, through the
    sequence-parallel forward).  With ``fastserve`` every rank reads the
    global batches and ``serving_forward_sharded`` scores each data
    rank's block of them (:func:`make_fastserve_infer`).  Under a model
    axis the module path head-shards (:func:`make_infer_fn`) and
    fastserve replicates the weights over it."""
    if fastserve and not normalize:
        raise ValueError("fastserve always folds normalization into the "
                         "weights; normalize=False is only supported on "
                         "the standard path")
    labels = np.asarray([r.label for r in records], np.int32)
    mine = np.arange(len(records))
    if mesh is not None:
        from ..parallel.mesh import DATA_AXIS, axis_rank, axis_sizes
        n_data = axis_sizes(mesh).get(DATA_AXIS, 1)
        if batch_size % n_data:
            raise ValueError(f"batch_size {batch_size} not divisible by the "
                             f"{n_data}-way data axis of the eval mesh")
        if not fastserve:
            mine = mine[axis_rank(mesh, DATA_AXIS)::n_data]
            batch_size //= n_data
    pipe = DataPipeline([records[i] for i in mine], batch_size=batch_size,
                        img_size=img_size, resize="exact",
                        num_workers=num_workers, shuffle=False,
                        drop_last=False)
    infer = (make_fastserve_infer(module, mesh=mesh) if fastserve
             else make_infer_fn(module, normalize=normalize, mesh=mesh))
    dev = module_device(module)
    prob1, pred = score_batches(infer, pipe.batches(), len(mine),
                                batch_size=batch_size, device=dev)
    if mesh is not None and not fastserve:
        from ..parallel.collectives import all_gather_rows
        from ..parallel.mesh import DATA_AXIS
        group = mesh.get_group(DATA_AXIS)
        got = [all_gather_rows(torch.from_numpy(a).to(dev), group).cpu()
               .numpy() for a in (mine, prob1, pred)]
        prob1, pred = np.zeros_like(prob1, shape=len(records)), np.zeros_like(
            pred, shape=len(records))
        prob1[got[0]], pred[got[0]] = got[1], got[2]
    return {"labels": labels, "prob1": prob1, "pred": pred}
