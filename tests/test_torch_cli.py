"""The port's CLI (`python -m embodied_clip_tpu_torch …`, `embodied_clip_tpu_torch/cli.py`)
and its real-weight parity check (`parity.verify_encoder_parity`) against the JAX
package's, on the CPU (`--device cpu`):
  - `list-configs` prints what the JAX CLI prints; `python -m embodied_clip_tpu_torch`
    runs; `probe-train --eval` without `--ckpt` exits 2; `verify-parity` exits 1 against
    another seed's checkpoint;
  - `verify_encoder_parity` as tests/test_verify_parity.py:40-68 holds JAX's, on an
    oracle-made full-size checkpoint (a few seconds here, where JAX's compile puts its
    own in the slow tier), with a twin on `clip_rn_tiny`; `convert-weights` feeds
    `verify-parity --variables` to the distances of `--torch-checkpoint`;
  - `probe-train`, `--eval --ckpt`, `train --config probe_*` and its `--eval`,
    `extract-features` and `convert-policy` run end to end.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import capture_reference_activations as CRA  # noqa: E402
import torch_oracle as O  # noqa: E402

from embodied_clip_tpu_torch import cli  # noqa: E402
from embodied_clip_tpu_torch.parity import verify_encoder_parity  # noqa: E402
from torch_probe_cases import one_thread, write_registry_store  # noqa: E402

TINY = dict(family="clip", stages=(1, 1, 1, 1), width=8, heads=4, out=16, image=128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_thread()


def _main(mod, argv):
    """(exit code, stdout) of `mod.main(argv)` in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            code = mod.main(argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue()


def test_list_configs_matches_jax_cli():
    from embodied_clip_tpu import cli as jcli

    code, out = _main(cli, ["list-configs"])
    jcode, jout = _main(jcli, ["list-configs"])
    assert code == jcode == 0 and out == jout
    assert len(out.split()) == 29


def test_module_entry_point_runs():
    out = subprocess.run([sys.executable, "-m", "embodied_clip_tpu_torch", "list-configs"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [ln for ln in _main(cli, ["list-configs"])[1].split()]
    assert _main(cli, ["no-such-command"])[0] == 2
    assert _main(cli, [])[0] == 0


def test_probe_train_eval_without_ckpt_exits_2(tmp_path):
    code, _ = _main(cli, ["probe-train", "--eval", "--data-dir", str(tmp_path),
                          "--embedding-type", "clip_avgpool",
                          "--prediction-type", "object_presence", "--device", "cpu"])
    assert code == 2


# ----------------------------------------------------------------- verify-parity

def _tiny_capture(tmp_path, monkeypatch, seed=7, n_frames=2):
    """A `clip_rn_tiny`-shaped oracle checkpoint (torch seed `seed`) and its activations
    captured by tools/capture_reference_activations.py: (checkpoint, activations)."""
    monkeypatch.setitem(CRA.SPECS, "clip_rn_tiny", TINY)
    torch.manual_seed(seed)
    model = O.ModifiedResNetOracle(TINY["stages"], TINY["width"], TINY["heads"], TINY["out"],
                                   TINY["image"])
    ckpt = str(tmp_path / f"tiny_sd_{seed}.pt")
    torch.save(model.state_dict(), ckpt)
    acts = str(tmp_path / f"tiny_acts_{seed}.npz")
    np.savez_compressed(acts, **CRA.capture("clip_rn_tiny", ckpt, n_frames=n_frames))
    return ckpt, acts


def test_verify_parity_tiny_oracle(tmp_path, monkeypatch):
    """Tier-1 twin of test_verify_parity_full_size_oracle: f32 passes at 1e-3 on every
    key; int8 runs the quantized graph (farther than f32); another seed's weights fail."""
    ckpt, acts = _tiny_capture(tmp_path, monkeypatch)
    r = verify_encoder_parity("clip_rn_tiny", acts, torch_checkpoint=ckpt, device="cpu")
    assert r["pass"], json.dumps(r, indent=2)
    assert set(r["per_key_cosine_distance"]) == {"clip_conv", "clip_avgpool", "clip_attnpool"}
    assert r["frames"] == 2 and r["dtype"] == "float32"
    r8 = verify_encoder_parity("clip_rn_tiny", acts, torch_checkpoint=ckpt, dtype="int8",
                               threshold=2e-2, device="cpu")
    assert r8["pass"], json.dumps(r8, indent=2)
    assert r8["worst"] > 10 * max(r["worst"], 1e-9)
    other, _ = _tiny_capture(tmp_path, monkeypatch, seed=8)
    bad = verify_encoder_parity("clip_rn_tiny", acts, torch_checkpoint=other, device="cpu")
    assert not bad["pass"] and bad["worst"] > 1e-2
    with pytest.raises(ValueError, match="dtype"):
        verify_encoder_parity("clip_rn_tiny", acts, torch_checkpoint=ckpt, dtype="int4",
                              device="cpu")


def test_verify_parity_cli_and_converted_weights(tmp_path, monkeypatch):
    """`verify-parity` exits 0 on the right weights and 1 on another seed's. The state
    dict of `convert-weights` gives the distances of `--torch-checkpoint` exactly in
    f32, bf16 and int8. A `--fold-bn` file holds BN folded in f32: in f32 its graph's
    distances equal those of the unfolded one up to the fold's rounding; in bf16 and
    int8 it rounds the folded weights to bf16 where the unfolded encoder folds its
    bf16 weights, so there it is held to the threshold only."""
    ckpt, acts = _tiny_capture(tmp_path, monkeypatch)
    other, _ = _tiny_capture(tmp_path, monkeypatch, seed=8)
    base = ["verify-parity", "--encoder", "clip_rn_tiny", "--activations", acts,
            "--device", "cpu"]
    code, out = _main(cli, base + ["--torch-checkpoint", ckpt])
    assert code == 0 and json.loads(out)["pass"]
    code, out = _main(cli, base + ["--torch-checkpoint", other])
    assert code == 1 and not json.loads(out)["pass"]
    for fold in (False, True):
        sd = str(tmp_path / f"converted_{fold}.pt")
        code, out = _main(cli, ["convert-weights", "--torch-checkpoint", ckpt, "--encoder",
                                "clip_rn_tiny", "--output", sd, "--device", "cpu"]
                          + (["--fold-bn"] if fold else []))
        assert code == 0 and json.loads(out)["folded"] == fold
        for dtype in ("float32", "bfloat16", "int8"):
            want = verify_encoder_parity("clip_rn_tiny", acts, torch_checkpoint=ckpt,
                                         dtype=dtype, threshold=2e-2, device="cpu")
            got = verify_encoder_parity("clip_rn_tiny", acts, variables=sd, dtype=dtype,
                                        threshold=2e-2, device="cpu")
            assert got["pass"]
            g, w = got["per_key_cosine_distance"], want["per_key_cosine_distance"]
            if not fold:
                assert g == w, dtype
            elif dtype == "float32":
                for k in w:
                    assert abs(g[k] - w[k]) <= 1e-9 + 1e-2 * w[k], (k, g[k], w[k])


@pytest.mark.parametrize("encoder,make", [
    ("clip_rn50", lambda: O.ModifiedResNetOracle((3, 4, 6, 3), 64, 32, 1024, 224)),
    ("imagenet_rn18", lambda: O.TVResNetTrunk((2, 2, 2, 2), block="basic")),
])
def test_verify_parity_full_size_oracle(tmp_path, encoder, make):
    torch.manual_seed(7)
    model = make()
    ckpt = str(tmp_path / f"{encoder}_sd.pt")
    torch.save(model.state_dict(), ckpt)
    acts_path = str(tmp_path / "ref_acts.npz")
    np.savez_compressed(acts_path, **CRA.capture(encoder, ckpt, n_frames=2))
    result = verify_encoder_parity(encoder, acts_path, torch_checkpoint=ckpt,
                                   dtype="float32", threshold=1e-3, device="cpu")
    assert result["pass"], json.dumps(result, indent=2)
    expected = {"clip_rn50": {"clip_conv", "clip_avgpool", "clip_attnpool"},
                "imagenet_rn18": {"imagenet_conv", "imagenet_avgpool"}}[encoder]
    assert set(result["per_key_cosine_distance"]) == expected


def test_verify_parity_int8_runs_quantized_graph(tmp_path):
    torch.manual_seed(7)
    model = O.TVResNetTrunk((2, 2, 2, 2), block="basic")
    ckpt = str(tmp_path / "rn18_sd.pt")
    torch.save(model.state_dict(), ckpt)
    acts_path = str(tmp_path / "ref_acts.npz")
    np.savez_compressed(acts_path, **CRA.capture("imagenet_rn18", ckpt, n_frames=2))
    r_f32 = verify_encoder_parity("imagenet_rn18", acts_path, torch_checkpoint=ckpt,
                                  dtype="float32", device="cpu")
    r_int8 = verify_encoder_parity("imagenet_rn18", acts_path, torch_checkpoint=ckpt,
                                   dtype="int8", threshold=2e-2, device="cpu")
    assert r_int8["pass"], json.dumps(r_int8, indent=2)
    assert r_int8["worst"] > 10 * max(r_f32["worst"], 1e-9)


# ---------------------------------------------------------------- the other commands

@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return write_registry_store(tmp_path_factory.mktemp("cli_store"))


def test_probe_train_then_eval_from_best(store, tmp_path):
    common = ["--data-dir", store, "--embedding-type", "clip_attnpool",
              "--prediction-type", "free_space", "--device", "cpu"]
    code, out = _main(cli, ["probe-train", *common, "--max-epochs", "2",
                            "--log-dir", str(tmp_path / "logs"),
                            "--ckpt-dir", str(tmp_path / "ckpt")])
    trained = json.loads(out)
    assert code == 0 and set(trained) == {"val", "test"}
    assert os.listdir(tmp_path / "logs" / "free_space" / "clip_attnpool")
    code, out = _main(cli, ["probe-train", *common, "--eval", "--ckpt",
                            str(tmp_path / "ckpt" / "best.pt")])
    evaluated = json.loads(out)
    assert code == 0 and set(evaluated) == {"test"}
    for k in ("loss", "accuracy"):
        assert abs(evaluated["test"][k] - trained["test"][k]) <= 1e-6


def test_train_probe_config_and_eval(store, tmp_path, monkeypatch):
    from embodied_clip_tpu_torch.training import supervised

    argv = ["train", "--config", "probe_object_presence_clip_avgpool", "--output-dir",
            str(tmp_path / "out"), "--device", "cpu", "--override", f"data_dir={store}",
            "max_epochs=2", f"log_dir={tmp_path / 'logs'}"]
    code, out = _main(cli, argv)
    trained = json.loads(out)
    assert code == 0 and (tmp_path / "out" / "best.pt").is_file()

    def no_fit(self, dm):
        raise AssertionError("--eval must not train")

    monkeypatch.setattr(supervised.ProbeTrainer, "fit", no_fit)
    code, out = _main(cli, argv[:7] + ["--eval"] + argv[7:])
    assert code == 0
    assert abs(json.loads(out)["test"]["loss"] - trained["test"]["loss"]) < 1e-5


def test_extract_features_cli(tmp_path):
    from embodied_clip_tpu_torch.parity import golden_frames

    frames = golden_frames(3, size=48)
    d = tmp_path / "scenes" / "train"
    d.mkdir(parents=True)
    sem = np.zeros((48, 48, 3), np.uint8)
    sem[:16, :16] = (10, 20, 30)
    np.save(str(d / "FloorPlan1.npy"), [
        {"frame": f, "semantic_frame": sem, "object_id_to_color": {"Mug": (10, 20, 30)},
         "valid_moves_forward": 12} for f in frames])
    code, _ = _main(cli, ["extract-features", "--data-dir", str(tmp_path / "scenes"),
                          "--output-dir", str(tmp_path / "out"), "--encoders",
                          "clip_rn_tiny", "--batch-size", "2", "--device", "cpu"])
    assert code == 0
    with np.load(str(tmp_path / "out" / "thor_train.npz")) as z:
        assert z["clip_conv"].shape == (3, 4, 4, 256) and z["clip_attnpool"].shape == (3, 16)
        assert z["free_space"].tolist() == [12, 12, 12]
        assert z["object_localization"][:, 0].sum() == 3 and z["object_presence"].sum() == 3


def test_convert_policy_cli(tmp_path):
    from embodied_clip_tpu_torch.models.allenact_policy import AllenActResnetPolicy
    from embodied_clip_tpu_torch.utils.checkpoint import restore_pytree

    policy = AllenActResnetPolicy(in_channels=16, grid=4, hidden=32, seed=3)
    src = str(tmp_path / "released.pt")
    torch.save({"model_state_dict": policy.state_dict()}, src)
    out_path = str(tmp_path / "converted.pt")
    code, out = _main(cli, ["convert-policy", "--torch-checkpoint", src, "--output",
                            out_path, "--grid", "4", "--device", "cpu"])
    assert code == 0
    saved = restore_pytree(out_path)
    assert set(saved) == {"params", "allenact_config"}
    cfg = saved["allenact_config"]
    assert (cfg["in_channels"], cfg["grid"], cfg["hidden"]) == (16, 4, 32)
    for k, v in policy.state_dict().items():
        assert torch.equal(saved["params"][k], v), k
    assert json.loads(out)["config"]["hidden"] == 32


def test_new_modules_import_no_optional_dependency():
    """Every module of the package imports without JAX, ai2thor or PIL (imported inside
    the functions that need them), and the probing stack's modules are among them."""
    code = ("import sys, pkgutil, importlib, embodied_clip_tpu_torch as p\n"
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
            "for n in names:\n"
            "    importlib.import_module(n)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'embodied_clip_tpu', 'ai2thor', 'PIL')]\n"
            "assert not bad, bad\n"
            "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for mod in ("cli", "__main__", "constants", "parity", "utils.metrics", "utils.prefetch",
                "models.probes", "models.convert", "data.probing", "data.feature_store",
                "training.supervised", "training.optim", "config.experiments",
                "generate_data.extract", "generate_data.thor_frames",
                "generate_data.reachable_metadata"):
        assert f"embodied_clip_tpu_torch.{mod}" in names, mod
