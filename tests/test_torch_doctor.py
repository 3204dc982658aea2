"""The port's ``doctor`` (``cli/doctor.py``) on a machine without a card
or nvcc: every JAX check name present, nothing FAILs, the device checks
and the kernel probe WARN, the host codec builds or says why, and the
behaviour of tests/test_doctor.py: the ``--only`` filter, ``--json``, a
probe that raises reports FAIL, an unknown name errors."""

import json

import pytest
import torch

from vit_spoof_detection_pda_tpu.cli import doctor as jdoctor
from vit_spoof_detection_pda_tpu_torch.cli import doctor
from vit_spoof_detection_pda_tpu_torch.cli.doctor import (FAIL, OK, WARN,
                                                          run_doctor)
from vit_spoof_detection_pda_tpu_torch.data import native
from vit_spoof_detection_pda_tpu_torch.ops import probe


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_doctor_no_failures_without_a_card(no_card):
    results = run_doctor()
    by_name = {r["check"]: r for r in results}
    assert [r["check"] for r in results] == [
        fn._check_name for fn in jdoctor.CHECKS]
    assert not [r for r in results if r["status"] == FAIL], results
    for name in ("versions", "compile_cache", "config_presets"):
        assert by_name[name]["status"] == OK, by_name[name]
    for name in ("backend", "device_exec", "device_memory", "mesh", "pallas"):
        assert by_name[name]["status"] == WARN, by_name[name]
    assert "tensor parallelism, FSDP and the pipeline run" in by_name[
        "mesh"]["note"]
    # the host codec builds wherever g++, libjpeg and libpng are: a PNG
    # round trip then; else a warning that carries the build's error
    codec = by_name["native_codec"]
    if native.get_lib() is not None:
        assert codec["status"] == OK and codec["png_roundtrip"] == \
            "bit-exact", codec
    else:
        assert codec["status"] == WARN and codec["build_error"], codec
    assert by_name["versions"]["torch"] == torch.__version__
    assert by_name["config_presets"]["presets"] == jdoctor.run_doctor(
        ["config_presets"])[0]["presets"]


def test_pallas_probe_runs_the_plain_version_without_a_card(no_card):
    before = probe.LAUNCHES["doctor_probe"]
    (r,) = run_doctor(["pallas"])
    assert r["status"] == WARN and "plain version" in r["note"]
    assert probe.LAUNCHES["doctor_probe"] == before
    x = torch.ones((8, 128))
    assert probe.doctor_probe(x).sum().item() == 2048.0


def test_doctor_only_filter_and_cli_json(capsys):
    doctor.main(["--json", "--only", "versions", "config_presets"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.strip()]
    assert [ln["check"] for ln in lines] == ["versions", "config_presets"]
    assert all(ln["status"] == "ok" for ln in lines)


def test_doctor_human_output_ends_with_worst(capsys, no_card):
    doctor.main(["--only", "versions", "mesh"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "doctor: warn (see above)"


def test_doctor_probe_exception_reports_fail(monkeypatch, capsys):
    """A crashing probe must not kill the rest of the report; the CLI then
    exits 1."""
    def boom():
        raise RuntimeError("probe exploded")

    boom._check_name = "versions"
    monkeypatch.setattr(doctor, "CHECKS", [boom, doctor.check_config_presets])
    results = doctor.run_doctor()
    assert results[0]["status"] == FAIL
    assert "probe exploded" in results[0]["error"]
    assert results[1]["status"] == OK
    with pytest.raises(SystemExit) as e:
        doctor.main(["--json"])
    assert e.value.code == 1


def test_doctor_unknown_check_name_errors():
    with pytest.raises(ValueError, match="unknown check name"):
        run_doctor(["backends"])
    with pytest.raises(SystemExit) as e:
        doctor.main(["--only", "backends"])
    assert e.value.code == 2


def test_doctor_verb_through_the_dispatcher(capsys, no_card):
    from vit_spoof_detection_pda_tpu_torch.__main__ import main
    assert main(["doctor", "--json", "--only", "compile_cache"]) == 0
    (line,) = capsys.readouterr().out.splitlines()
    r = json.loads(line)
    assert r["check"] == "compile_cache" and r["status"] == OK
    assert "build/kernels" in r["dir"]
