"""Operations and bytes of the ViT's work, from its shapes, and the peaks
they are held against.

Counted over the real tokens (197 at 224 px) wherever the program pads
its stream (to 200 rows): the pad rows are the program's choice, not
work the model needs.  A product of an ``[m, k]`` and a ``[k, n]``
operand is ``2 m k n`` operations.  Bytes count each input once and each
output once, at the dtype the kernel reads or writes, whatever the
kernel reads again.  Every function takes the configuration's dict
(``configs/<name>.json``).
"""

from __future__ import annotations

# the published peaks of one H100 SXM (NVIDIA's data sheet, dense, at the
# full 700 W power limit)
PEAKS = {
    "bf16_flops": 989e12,      # tensor cores, bf16 and fp16
    "f32_flops": 67e12,        # float32 outside the tensor cores
    "hbm_bytes": 3.35e12,      # HBM3, bytes per second
}


def tokens(cfg) -> int:
    """Real tokens of an image: its patches and the CLS token."""
    return (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1


def layer_flops(cfg) -> int:
    """One encoder layer over one image: qkv, proj, fc1 and fc2
    (``2 t D (3D + D + 2 F)``) and the attention's two ``[t, t] x Dh``
    products per head (``4 t^2 D``)."""
    t = tokens(cfg)
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    return 2 * t * d * (4 * d + 2 * f) + 4 * t * t * d


def stem_flops(cfg) -> int:
    p, d = cfg["patch_size"], cfg["hidden_size"]
    return 2 * (tokens(cfg) - 1) * (p * p * cfg["num_channels"]) * d


def head_flops(cfg) -> int:
    d = cfg["hidden_size"]
    if cfg["head"] == "linear":
        return 2 * d * cfg["num_labels"]
    h = cfg["head_hidden_size"]
    return 2 * d * h + 2 * h * cfg["num_labels"]


def forward_flops(cfg) -> int:
    """One image through the whole model: the stem, every layer, the
    head (3.5127e10 at ViT-B/16, 224 px, the MLP head)."""
    return (stem_flops(cfg) + cfg["num_hidden_layers"] * layer_flops(cfg)
            + head_flops(cfg))


def train_flops(cfg) -> int:
    """A training image: the forward and a backward of twice its work."""
    return 3 * forward_flops(cfg)


def bound_s(flops: float, nbytes: float, peak_flops: float,
            peak_bytes: float = PEAKS["hbm_bytes"]) -> tuple:
    """The least time the chip could take, ``(seconds, "operations" |
    "bytes")``: the larger of operations over the peak rate and bytes over
    the peak bandwidth."""
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bytes
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# --------------------------------------------------------------------------
# kernels (one call each, B images)
# --------------------------------------------------------------------------


def attention_block(cfg, b: int, itemsize: int = 2) -> tuple:
    """Kernel 1 (LN, qkv, attention, proj with the residual): its
    products; the stream in and out, the two matrices, the LN, qkv and
    proj vectors (f32)."""
    t, d = tokens(cfg), cfg["hidden_size"]
    flops = 2 * b * t * d * 4 * d + 4 * b * t * t * d
    nbytes = 2 * b * t * d * itemsize + 4 * d * d * itemsize + 6 * d * 4
    return flops, nbytes


def mlp_block(cfg, b: int, itemsize: int = 2) -> tuple:
    """Kernel 2 (LN, fc1 with GELU, fc2 with the residual)."""
    rows, d, f = b * tokens(cfg), cfg["hidden_size"], cfg["intermediate_size"]
    flops = 4 * rows * d * f
    nbytes = (2 * rows * d * itemsize + 2 * d * f * itemsize
              + (3 * d + f) * 4)
    return flops, nbytes


def attention_qkv(cfg, b: int, itemsize: int) -> tuple:
    """Kernel 8 (the attention core on the fused projection): the two
    ``[t, t] x Dh`` products per head; qkv in, the head outputs out."""
    t, d = tokens(cfg), cfg["hidden_size"]
    return 4 * b * t * t * d, b * t * 4 * d * itemsize


def attention_qkv_bwd(cfg, b: int, itemsize: int = 2) -> tuple:
    """Kernel 4 (the attention backward): the five ``[t, t] x Dh``
    products per head (scores, dv, dw, dq, dk); qkv and the outputs'
    cotangent in, dqkv out."""
    t, d = tokens(cfg), cfg["hidden_size"]
    return 10 * b * t * t * d, b * t * 7 * d * itemsize


KERNELS = {
    "attention_block": attention_block,
    "mlp_block": mlp_block,
    "attention_qkv": attention_qkv,
    "attention_qkv_bwd": attention_qkv_bwd,
}
