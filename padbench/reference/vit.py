"""Plain float32 ViT-B/16 with the anti-spoof MLP head or a linear head:
the forward, the focal loss, the gradients and the AdamW update.

This is the benchmark's yardstick.  It follows the published model
(Dosovitskiy et al., arXiv:2010.11929; timm ``vit_base_patch16_224`` and
HF ``google/vit-base-patch16-224``) and the reference training script's
head and optimizer, in plain ``torch`` operations at float32 with TF32
off.  It imports nothing of the program under test and takes nothing the
program made: the weights arrive in the published (timm) key layout from
the benchmark, and the normalization, the losses and the updates are
worked out here.

Departures from the published description, each on purpose:

- The encoder's GELU is the exact (erf) form of the published model.  The
  program's serving paths run the tanh form as a serving policy; that gap
  is part of what the comparison reads.
- Every product goes through :func:`matmul` (or :func:`conv` for the
  patch embed), which rounds both operands with ``quant`` first.  The
  identity keeps the reference at float32; the controls pass a lower
  precision there (:func:`fp8_e4m3`, :func:`tf32`).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# --------------------------------------------------------------------------
# operand rounding: the reference at f32 and its lower-precision controls
# --------------------------------------------------------------------------


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


class _RoundSTE(torch.autograd.Function):
    """Round in the forward, pass the gradient through unchanged."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _fp8_round(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return ((x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale)


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3 (amax to 448), back in float32: the
    control for a configuration that states bfloat16."""
    return _RoundSTE.apply(x, _fp8_round)


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest float32 with 10 mantissa bits (TF32's
    operands), ties away from zero as the tensor cores' conversion."""
    x = x.float().contiguous()
    i = x.view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """TF32 operands, emulated so that it reads the same on any device:
    the control for a configuration that states float32 with TF32 off."""
    return _RoundSTE.apply(x, _tf32_round)


CONTROLS = {"fp8_e4m3": fp8_e4m3, "tf32": tf32}


@contextlib.contextmanager
def no_tf32():
    """float32 products stay float32 while the reference runs."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def matmul(a, b, quant=exact):
    return torch.matmul(quant(a), quant(b))


def linear(x, w, b, quant=exact):
    """``x @ w.T + b`` with a ``[out, in]`` weight (torch's layout)."""
    return matmul(x, w.t(), quant) + b


def conv(x, w, b, stride, quant=exact):
    return F.conv2d(quant(x), quant(w), b, stride=stride)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 ``[B, H, W, 3]`` -> ToTensor and the ImageNet normalization,
    float32 ``[B, 3, H, W]``."""
    dev = images_u8.device
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
    x = images_u8.to(torch.float32) / 255.0
    return ((x - mean) / std).permute(0, 3, 1, 2)


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def gelu_erf(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gelu_tanh(x):
    """The tanh form, which the program's serving paths run as policy;
    the reference uses it only to show what that departure reads."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def attention(x, w, p, heads, quant):
    b, t, d = x.shape
    dh = d // heads
    qkv = linear(x, w[p + "attn.qkv.weight"], w[p + "attn.qkv.bias"], quant)
    q, k, v = qkv.view(b, t, 3, heads, dh).permute(2, 0, 3, 1, 4)
    scores = matmul(q, k.transpose(-1, -2), quant) / math.sqrt(dh)
    out = matmul(torch.softmax(scores, dim=-1), v, quant)
    out = out.transpose(1, 2).reshape(b, t, d)
    return linear(out, w[p + "attn.proj.weight"], w[p + "attn.proj.bias"],
                  quant)


def encoder(w, images_u8, cfg, quant=exact, act=gelu_erf):
    """The ViT trunk -> the CLS feature after the final LayerNorm
    ``[B, D]``.  ``w``: timm keys under ``vit.``."""
    x = normalize(images_u8)
    p = cfg["patch_size"]
    x = conv(x, w["vit.patch_embed.proj.weight"],
             w["vit.patch_embed.proj.bias"], p, quant)
    x = x.flatten(2).transpose(1, 2)                        # [B, N, D]
    cls = w["vit.cls_token"].expand(x.shape[0], 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + w["vit.pos_embed"]
    eps = cfg["layer_norm_eps"]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"vit.blocks.{i}."
        h = layer_norm(x, w[pre + "norm1.weight"], w[pre + "norm1.bias"], eps)
        x = x + attention(h, w, pre, cfg["num_attention_heads"], quant)
        h = layer_norm(x, w[pre + "norm2.weight"], w[pre + "norm2.bias"], eps)
        h = act(linear(h, w[pre + "mlp.fc1.weight"],
                       w[pre + "mlp.fc1.bias"], quant))
        x = x + linear(h, w[pre + "mlp.fc2.weight"], w[pre + "mlp.fc2.bias"],
                       quant)
    x = layer_norm(x[:, 0], w["vit.norm.weight"], w["vit.norm.bias"], eps)
    return x


def dropout(x, mask, rate):
    """Inverted dropout with a given keep mask (None: off)."""
    if mask is None:
        return x
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


def head_logits(w, feats, cfg, quant=exact, masks=None):
    """The classifier on the CLS feature -> float32 logits ``[B, 2]``.
    ``mlp``: the reference script's ``classifier`` Sequential (LayerNorm
    eps 1e-5, Dropout, Linear, erf GELU, Dropout, Linear); ``linear``: one
    Linear.  ``masks``: the two dropout keep masks, or None in eval."""
    if cfg["head"] == "linear":
        return linear(feats, w["classifier.weight"], w["classifier.bias"],
                      quant)
    m1, m2 = masks if masks is not None else (None, None)
    rate = cfg["head_dropout"]
    f = layer_norm(feats, w["classifier.0.weight"], w["classifier.0.bias"],
                   cfg["head_layer_norm_eps"])
    f = dropout(f, m1, rate)
    f = gelu_erf(linear(f, w["classifier.2.weight"], w["classifier.2.bias"],
                        quant))
    f = dropout(f, m2, rate)
    return linear(f, w["classifier.5.weight"], w["classifier.5.bias"], quant)


def logits(w, images_u8, cfg, quant=exact, masks=None, act=gelu_erf):
    return head_logits(w, encoder(w, images_u8, cfg, quant, act), cfg,
                       quant, masks)


@torch.no_grad()
def p_live(w, images_u8, cfg, quant=exact, block: int = 64,
           act=gelu_erf) -> torch.Tensor:
    """P(live) = softmax column 1, float32 ``[B]``, in blocks of ``block``
    images so that it fits beside nothing else."""
    out = []
    with no_tf32():
        for i in range(0, images_u8.shape[0], block):
            lg = logits(w, images_u8[i:i + block], cfg, quant, act=act)
            out.append(torch.softmax(lg, dim=-1)[:, 1])
    return torch.cat(out)


# --------------------------------------------------------------------------
# training: focal loss, the global-norm clip and AdamW
# --------------------------------------------------------------------------


def focal_loss(lg, labels, alpha, gamma):
    """``mean(alpha (1 - pt)^gamma CE)``, ``pt = exp(-CE)``."""
    ce = -torch.log_softmax(lg, dim=-1).gather(1, labels[:, None])[:, 0]
    return (alpha * (1.0 - torch.exp(-ce)) ** gamma * ce).mean()


def cosine_lr(count, opt):
    """The reference script's LR: cosine annealing over ``total - warmup``
    steps from the full rate at step 0, without a ramp (its warmup steps
    are computed and never applied), float32 as the program computes it."""
    f = np.float32
    t_max = max(opt["total_steps"] - opt["warmup_steps"], 1)
    return float(f(opt["min_lr"]) + f(opt["learning_rate"] - opt["min_lr"])
                 * f(0.5) * (f(1) + np.cos(f(np.pi) * f(count) / f(t_max))))


def dropout_masks(step_seed: int, batch: int, cfg, device):
    """The head's two keep masks of one step: ``rand < 1 - rate`` over
    ``[B, D]`` then ``[B, head_hidden]`` from one generator on ``device``
    seeded by ``step_seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed)
    keep = 1.0 - cfg["head_dropout"]
    m1 = torch.rand((batch, cfg["hidden_size"]), generator=gen,
                    device=device) < keep
    m2 = torch.rand((batch, cfg["head_hidden_size"]), generator=gen,
                    device=device) < keep
    return m1, m2


class AdamW:
    """Global-norm clip, then AdamW with decoupled weight decay on every
    leaf (torch ``AdamW`` / optax ``adamw``, which agree), on a dict of
    float32 leaves."""

    def __init__(self, opt):
        self.opt = opt
        self.count = 0
        self.mu, self.nu = {}, {}

    @torch.no_grad()
    def clip(self, grads):
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        limit = self.opt["max_grad_norm"]
        if float(norm) >= limit:
            grads = {k: g / norm * limit for k, g in grads.items()}
        return grads

    @torch.no_grad()
    def step(self, params, grads):
        o = self.opt
        b1, b2 = o["beta1"], o["beta2"]
        t = self.count + 1
        lr = cosine_lr(self.count, o)
        for k, g in grads.items():
            mu = self.mu.setdefault(k, torch.zeros_like(g))
            nu = self.nu.setdefault(k, torch.zeros_like(g))
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).add_(g * g, alpha=1 - b2)
            u = (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t))
                                       + o["eps"])
            params[k].sub_(lr * (u + o["weight_decay"] * params[k]))
        self.count = t


def train_steps(w0, batches, step_seeds, cfg, opt, quant=exact):
    """Train a copy of ``w0`` for ``len(batches)`` steps.  ``batches``:
    ``(uint8 images, int64 labels)`` on the device; ``step_seeds``: each
    step's dropout seed (:func:`dropout_masks`).  Returns ``{"loss": [per
    step], "grad1": the first step's clipped gradient, "params": the
    leaves after the last step}``."""
    params = {k: v.detach().clone() for k, v in w0.items()}
    adam = AdamW(opt)
    losses, grad1 = [], None
    with no_tf32():
        for (images, labels), s in zip(batches, step_seeds):
            leaves = {k: v.requires_grad_() for k, v in params.items()}
            masks = dropout_masks(s, images.shape[0], cfg, images.device)
            loss = focal_loss(logits(leaves, images, cfg, quant, masks),
                              labels, opt["focal_alpha"], opt["focal_gamma"])
            g = torch.autograd.grad(loss, list(leaves.values()))
            grads = adam.clip(dict(zip(leaves.keys(), g)))
            params = {k: v.detach() for k, v in leaves.items()}
            if grad1 is None:
                grad1 = grads
            adam.step(params, grads)
            losses.append(float(loss.detach()))
    return {"loss": losses, "grad1": grad1, "params": params}
