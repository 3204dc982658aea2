"""The port's copy of the config tree (config.py) against the JAX
package's: the same fields and defaults, presets, dotted and env
overrides, and the JSON round trip (a file written by one loads in the
other)."""

import dataclasses
import json

import pytest

from vit_spoof_detection_pda_tpu import config as J
from vit_spoof_detection_pda_tpu_torch import config as T


def _fields(cls):
    return [(f.name, f.type) for f in dataclasses.fields(cls)]


def test_same_tree_and_defaults():
    assert _fields(T.Config) == _fields(J.Config)
    for f in dataclasses.fields(J.Config):
        sub = getattr(J.Config(), f.name)
        if dataclasses.is_dataclass(sub):
            assert _fields(type(getattr(T.Config(), f.name))) == _fields(
                type(sub)), f.name
    assert T.Config().to_dict() == J.Config().to_dict()


@pytest.mark.parametrize("name", sorted(J.PRESETS))
def test_presets_match(name):
    assert sorted(T.PRESETS) == sorted(J.PRESETS)
    assert T.Config.preset(name).to_dict() == J.Config.preset(name).to_dict()


def test_overrides_env_and_json_round_trip(monkeypatch, tmp_path):
    over = {"optim.learning_rate": 1e-4, "model.mlp_vjp": "fused",
            "model.compute_dtype": "float32", "train_aug.color_jitter":
            [0.3, 0.3, 0.3, 0.1], "checkpoint.async_save": True}
    t, j = T.Config().with_overrides(over), J.Config().with_overrides(over)
    assert t.to_dict() == j.to_dict()
    monkeypatch.setenv("PAD_optim__num_epochs", "7")
    monkeypatch.setenv("PAD_model__gelu", "tanh")
    monkeypatch.setenv("PAD_no__such_field", "1")            # ignored
    te, je = t.with_env_overrides(), j.with_env_overrides()
    assert te.to_dict() == je.to_dict()
    assert te.optim.num_epochs == 7 and te.model.gelu == "tanh"
    for src, dst in ((te, J.Config), (je, T.Config)):
        path = tmp_path / "c.json"
        path.write_text(src.to_json())
        back = dst.from_json_file(str(path))
        assert back.to_json() == te.to_json()
        assert back.train_aug.color_jitter == (0.3, 0.3, 0.3, 0.1)  # tuple
    with pytest.raises((AttributeError, TypeError, KeyError, ValueError)):
        T.Config().with_overrides({"optim.no_such_field": 1})
