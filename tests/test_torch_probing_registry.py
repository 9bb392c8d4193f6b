"""The port's probing grid in the experiment registry (`config/experiments.py`:
`ProbeExperiment`, `_register_probe_grid`) against the JAX package's, on the CPU: the
same 29 names, the same probe fields (the port adds `device`), every probe name trains
2 epochs as registered, and `evaluate` is eval-only (tests/test_registry_trains.py:
74-95).
"""

import dataclasses as dc

import numpy as np
import pytest

from embodied_clip_tpu.config import experiments as jexp

from embodied_clip_tpu_torch.config import experiments as pexp
from torch_probe_cases import one_thread, write_registry_store

PROBE_NAMES = sorted(n for n in pexp.list_experiments() if n.startswith("probe_"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_thread()


@pytest.fixture(scope="module")
def probe_data_dir(tmp_path_factory):
    return write_registry_store(tmp_path_factory.mktemp("registry_probe_data"))


def test_probe_grid_matches_jax():
    assert pexp.list_experiments() == jexp.list_experiments()
    assert PROBE_NAMES == sorted(n for n in jexp.list_experiments() if n.startswith("probe_"))
    assert len(PROBE_NAMES) == 11
    for name in PROBE_NAMES:
        j, p = jexp.get_experiment(name), pexp.get_experiment(name)
        jf = {f.name for f in dc.fields(j)}
        pf = {f.name for f in dc.fields(p)}
        assert pf - jf == {"device"} and jf <= pf
        for f in sorted(jf):
            assert getattr(p, f) == getattr(j, f), (name, f)
        assert p.device == "cuda"
    ov = ["max_epochs=3", "lr=0.01", "data_dir=/x", "log_dir=none"]
    j = jexp.get_experiment("probe_free_space_clip_attnpool", ov)
    p = pexp.get_experiment("probe_free_space_clip_attnpool", ov + ["device=cpu"])
    assert (p.max_epochs, p.lr, p.data_dir, p.log_dir) == (j.max_epochs, j.lr, j.data_dir,
                                                           j.log_dir) == (3, 0.01, "/x", None)
    assert p.device == "cpu"


@pytest.mark.parametrize("name", PROBE_NAMES)
def test_registered_probe_trains(name, probe_data_dir, tmp_path):
    """Every probe_{prediction}_{embedding} entry runs fit → test as registered."""
    exp = dc.replace(pexp.get_experiment(name), data_dir=probe_data_dir, max_epochs=2,
                     log_dir=str(tmp_path / "logs"), device="cpu")
    out = exp.train(output_dir=str(tmp_path / "ckpt"))
    assert np.isfinite(out["test"]["loss"]), (name, out)
    assert (tmp_path / "ckpt" / "best.pt").is_file()


def test_probe_evaluate_is_eval_only(probe_data_dir, tmp_path, monkeypatch):
    """`train --config probe_* --eval` runs an eval-only pass from the best checkpoint,
    never the fit."""
    from embodied_clip_tpu_torch.training import supervised

    exp = dc.replace(pexp.get_experiment("probe_object_presence_clip_avgpool"),
                     data_dir=probe_data_dir, max_epochs=1, log_dir=str(tmp_path / "logs"),
                     device="cpu")
    trained = exp.train(output_dir=str(tmp_path / "ckpt"))

    def no_fit(self, dm):
        raise AssertionError("evaluate() must not train")

    monkeypatch.setattr(supervised.ProbeTrainer, "fit", no_fit)
    out = exp.evaluate(output_dir=str(tmp_path / "ckpt"))
    assert np.isfinite(out["test"]["loss"])
    # restored best-val params → the fit's own best-ckpt test loss
    assert abs(out["test"]["loss"] - trained["test"]["loss"]) < 1e-5
    again = exp.evaluate(output_dir=str(tmp_path / "other"),
                         ckpt=str(tmp_path / "ckpt" / "best.pt"))
    assert again == out
    with pytest.raises(FileNotFoundError):
        exp.evaluate(output_dir=str(tmp_path / "empty"))
