"""The port's model registry and upstream-checkpoint converters against
the JAX package's: the four entries, their warnings, the placeholder,
the head-mismatch fallback, partial loads, Orbax and EMA refusals, HF
q/k/v fusion, and a ``.pth`` written by the JAX exporter loaded by both
registries.

Tolerance: f32 logits at atol 2e-4 / rtol 1e-4 (tests/test_torch_vit.py's
bound); converted tensors bit for bit.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_spoof_detection_pda_tpu.models import convert as jconvert
from vit_spoof_detection_pda_tpu.models import registry as jreg
from vit_spoof_detection_pda_tpu.models import vit as jvit
from vit_spoof_detection_pda_tpu_torch.models import convert as tconvert
from vit_spoof_detection_pda_tpu_torch.models import registry as treg
from vit_spoof_detection_pda_tpu_torch.models.resnet import ResNet50
from vit_spoof_detection_pda_tpu_torch.models.vit import (ViTAntiSpoof,
                                                          ViTLinearHead)


def test_the_four_entries_match_jax():
    assert list(treg.MODEL_REGISTRY) == list(jreg.MODEL_REGISTRY)
    for name, want in jreg.MODEL_REGISTRY.items():
        got = treg.MODEL_REGISTRY[name]
        assert (got.name, got.weights, got.placeholder, got.description) == (
            want.name, want.weights, want.placeholder, want.description)
        assert (got.weight_converter is None) == (want.weight_converter
                                                  is None)


@pytest.mark.parametrize("name,cls", [
    ("Custom_ViT_FineTuned", ViTAntiSpoof),
    ("Base_ViT_Pretrained", ViTLinearHead),
    ("ResNet50_Pretrained", ResNet50), ("SigNet_F", ResNet50)])
def test_random_init_warns_and_is_seeded(name, cls, caplog):
    with caplog.at_level(logging.WARNING):
        a = treg.build_model(name, img_size=32, seed=3, device="cpu")
    assert isinstance(a, cls) and not a.training
    text = caplog.text
    if treg.MODEL_REGISTRY[name].placeholder:
        assert "placeholder model — using UNTRAINED weights" in text
    else:
        assert "RANDOM init" in text
    b = treg.build_model(name, img_size=32, seed=3, device="cpu")
    c = treg.build_model(name, img_size=32, seed=4, device="cpu")
    ka = next(iter(a.state_dict()))
    wa, wb, wc = (m.state_dict()[ka] for m in (a, b, c))
    assert torch.equal(wa, wb)
    # fork_rng: the caller's generator is untouched by the build
    torch.manual_seed(0)
    want = torch.rand(3)
    torch.manual_seed(0)
    treg.build_model("SigNet_F", img_size=32, device="cpu")
    assert torch.equal(torch.rand(3), want)
    assert wa.shape == wc.shape


def test_missing_file_warns(tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        treg.build_model("SigNet_F", device="cpu")
        treg.build_model("ResNet50_Pretrained",
                         pretrained_path=str(tmp_path / "nope.pth"),
                         device="cpu")
    assert "weight file" in caplog.text and "missing — random init" in (
        caplog.text)


def test_orbax_directory_and_ema_raise(tmp_path, monkeypatch):
    """Checkpoint directories load since the training loop was ported
    (tests/test_torch_checkpoint.py); what still raises: a directory with
    no checkpoint, ``ema=True`` without a directory (a file carries no
    EMA shadow), and a JAX Orbax directory where ``orbax`` does not
    import."""
    from vit_spoof_detection_pda_tpu_torch.utils import checkpoint as tck

    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        treg.build_model("Custom_ViT_FineTuned", checkpoint_path=str(tmp_path),
                         device="cpu")
    with pytest.raises(ValueError, match="ema=True"):
        treg.build_model("Custom_ViT_FineTuned", ema=True, device="cpu")
    (tmp_path / "5" / "tree").mkdir(parents=True)        # Orbax's layout

    def no_orbax():
        raise ImportError("No module named 'orbax'")

    monkeypatch.setattr(tck, "_orbax", no_orbax)
    with pytest.raises(NotImplementedError, match="orbax"):
        treg.build_model("Custom_ViT_FineTuned", checkpoint_path=str(tmp_path),
                         device="cpu")


def test_jax_exported_pth_loads_in_both_registries(tmp_path):
    """save_torch_checkpoint's reference-format .pth (ViT-B/16, 32x32
    inputs) through JAX's build_model and the port's: the same logits."""
    jm = jvit.ViTAntiSpoof()
    variables = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    path = str(tmp_path / "best_model.pth")
    jconvert.save_torch_checkpoint(path, variables, epoch=3,
                                   metrics={"auc": 0.5})
    jmod, jvars = jreg.build_model("Custom_ViT_FineTuned",
                                   checkpoint_path=path, img_size=32)
    tmod = treg.build_model("Custom_ViT_FineTuned", checkpoint_path=path,
                            img_size=32, device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jmod.apply)(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def _resnet_sd(seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return {k: v.clone() for k, v in ResNet50().state_dict().items()}


def test_mismatched_head_keeps_random_init(tmp_path, caplog):
    sd = _resnet_sd(5)
    sd["fc.weight"] = torch.ones(1000, 2048)          # ImageNet's head
    sd["fc.bias"] = torch.ones(1000)
    path = tmp_path / "resnet50.pth"
    torch.save(sd, path)
    with caplog.at_level(logging.WARNING):
        m = treg.build_model("ResNet50_Pretrained", pretrained_path=str(path),
                             device="cpu", seed=7)
    assert "mismatched shapes" in caplog.text
    assert torch.equal(m.state_dict()["conv1.weight"], sd["conv1.weight"])
    assert m.fc.weight.shape == (2, 2048)
    fresh = treg.build_model("ResNet50_Pretrained", device="cpu", seed=7)
    assert torch.equal(m.fc.weight, fresh.fc.weight)


def test_all_mismatched_raises(tmp_path):
    sd = {k: v for k, v in _resnet_sd().items()}
    sd = {k: torch.zeros(tuple(s + 1 for s in v.shape)) if v.dim() else v
          for k, v in sd.items()}
    sd = {k: v for k, v in sd.items() if v.dim()}
    path = tmp_path / "wrong.pth"
    torch.save(sd, path)
    with pytest.raises(ValueError, match="ALL"):
        treg.build_model("ResNet50_Pretrained", pretrained_path=str(path),
                         device="cpu")


def test_partial_state_dict_keeps_init_for_the_missing(tmp_path, caplog):
    sd = _resnet_sd(6)
    del sd["layer4.2.conv3.weight"]
    path = tmp_path / "partial.pth"
    torch.save({"model_state_dict": sd}, path)
    with caplog.at_level(logging.WARNING):
        m = treg.build_model("ResNet50_Pretrained", pretrained_path=str(path),
                             device="cpu", seed=9)
    assert "was incomplete; 1 tensors kept init values" in caplog.text
    fresh = treg.build_model("ResNet50_Pretrained", device="cpu", seed=9)
    assert torch.equal(m.layer4[2].conv3.weight, fresh.layer4[2].conv3.weight)
    assert torch.equal(m.conv1.weight, sd["conv1.weight"])


def test_wrong_format_matches_nothing():
    with pytest.raises(KeyError, match="matched none"):
        tconvert.convert_partial(tconvert.antispoof_from_checkpoint,
                                 _resnet_sd(), ViTAntiSpoof(depth=1))


def _hf_from_linear_tree(params, depth):
    """An HF ViTForImageClassification state dict from a flax
    ViTLinearHead tree (q/k/v split out of the fused qkv)."""
    sd = {}
    vit = params["vit"]
    d = vit["cls_token"].shape[-1]
    k = vit["patch_embed"]["kernel"]
    p = int(round((k.shape[0] / 3) ** 0.5))
    sd["vit.embeddings.patch_embeddings.projection.weight"] = k.reshape(
        p, p, 3, d).transpose(3, 2, 0, 1)
    sd["vit.embeddings.patch_embeddings.projection.bias"] = vit[
        "patch_embed"]["bias"]
    sd["vit.embeddings.cls_token"] = vit["cls_token"]
    sd["vit.embeddings.position_embeddings"] = vit["pos_embed"]
    sd["vit.layernorm.weight"] = vit["norm"]["scale"]
    sd["vit.layernorm.bias"] = vit["norm"]["bias"]
    for i in range(depth):
        blk, b = vit[f"block{i}"], f"vit.encoder.layer.{i}"
        qkv_w = blk["attn"]["qkv"]["kernel"].T
        qkv_b = blk["attn"]["qkv"]["bias"]
        for j, part in enumerate(("query", "key", "value")):
            sd[f"{b}.attention.attention.{part}.weight"] = qkv_w[j * d:(j + 1) * d]
            sd[f"{b}.attention.attention.{part}.bias"] = qkv_b[j * d:(j + 1) * d]
        for mine, theirs in (("norm1", "layernorm_before"),
                             ("norm2", "layernorm_after")):
            sd[f"{b}.{theirs}.weight"] = blk[mine]["scale"]
            sd[f"{b}.{theirs}.bias"] = blk[mine]["bias"]
        for mine, theirs in ((blk["attn"]["proj"], "attention.output.dense"),
                             (blk["mlp"]["fc1"], "intermediate.dense"),
                             (blk["mlp"]["fc2"], "output.dense")):
            sd[f"{b}.{theirs}.weight"] = mine["kernel"].T
            sd[f"{b}.{theirs}.bias"] = mine["bias"]
    sd["classifier.weight"] = params["classifier"]["kernel"].T
    sd["classifier.bias"] = params["classifier"]["bias"]
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def test_hf_converter_fuses_qkv_as_jax_does():
    variables = jvit.ViTLinearHead().init(jax.random.PRNGKey(4),
                                          jnp.zeros((1, 32, 32, 3)))
    params = jax.tree.map(np.asarray, variables)["params"]
    hf = _hf_from_linear_tree(params, 12)
    want = tconvert.vit_linear_to_torch(
        jconvert.vit_linear_from_hf(hf, depth=12))
    got = tconvert.vit_linear_from_hf(hf, depth=12)
    assert sorted(got) == sorted(want) == sorted(
        ViTLinearHead(img_size=32).state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # one missing part drops the fused qkv weight and bias together
    del hf["vit.encoder.layer.3.attention.attention.key.bias"]
    part = tconvert.vit_linear_from_hf(hf, depth=12, tolerant=True)
    assert part["vit.blocks.3.attn.qkv.weight"] is tconvert.MISSING
    assert part["vit.blocks.3.attn.qkv.bias"] is tconvert.MISSING
    assert part["vit.blocks.2.attn.qkv.bias"] is not tconvert.MISSING
