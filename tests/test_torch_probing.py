"""The port's probe heads, losses and metrics (`embodied_clip_tpu_torch/models/probes.py`,
`utils/metrics.py`) against the JAX package's, on the CPU, from numpy seeds: the metrics
and `adaptive_avg_pool` within 1e-7; each probe's logits on JAX's params (carried across
by `from_flax_probe_params`) within 1e-5; `probe_loss` for the four prediction types
(free space with labels above MAX_FORWARD_STEPS) and `probe_metrics` within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.models import probes as jp
from embodied_clip_tpu.utils import metrics as jm

from embodied_clip_tpu_torch import constants
from embodied_clip_tpu_torch.models import probes as pp
from embodied_clip_tpu_torch.models.convert import from_flax_probe_params
from embodied_clip_tpu_torch.utils import metrics as pm


def test_constants_match_jax():
    from embodied_clip_tpu import constants as jc

    assert constants.TARGET_OBJECTS == jc.TARGET_OBJECTS and len(jc.TARGET_OBJECTS) == 52
    assert constants.MAX_FORWARD_STEPS == jc.MAX_FORWARD_STEPS == 10
    assert pp.PREDICTION_TYPES == jp.PREDICTION_TYPES
    assert pp.EMBEDDING_TYPES == jp.EMBEDDING_TYPES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rng = np.random.RandomState(seed)
    probs = rng.rand(64, 52).astype(np.float32)
    targets = (rng.rand(64, 52) > 0.7).astype(np.int64)
    labels = rng.randint(0, 11, 64)
    cases = [
        (pm.f1_score, jm.f1_score, (probs, targets)),
        (pm.binary_accuracy, jm.binary_accuracy, (probs[:, 0], targets[:, 0])),
        (pm.argmax_accuracy, jm.argmax_accuracy, (probs[:, :11], labels)),
        # nothing predicted, nothing true: 2·tp + fp + fn = 0 → F1 is 0
        (pm.f1_score, jm.f1_score, (np.zeros((4, 3), np.float32), np.zeros((4, 3)))),
    ]
    for port_fn, jax_fn, args in cases:
        got = float(port_fn(*(torch.from_numpy(np.asarray(a)) for a in args)))
        want = float(jax_fn(*(jnp.asarray(a) for a in args)))
        assert abs(got - want) <= 1e-7, (port_fn.__name__, got, want)


@pytest.mark.parametrize("hw,out", [((7, 7), (3, 3)), ((5, 9), (3, 3)), ((1, 1), (3, 3)),
                                    ((7, 7), (2, 4))])
def test_adaptive_avg_pool_matches_jax(hw, out):
    x = np.random.RandomState(3).randn(2, *hw, 6).astype(np.float32)
    got = pp.adaptive_avg_pool(torch.from_numpy(x), out).numpy()
    want = np.asarray(jp.adaptive_avg_pool(jnp.asarray(x), out))
    assert got.shape == want.shape == (2, *out, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    # torch's AdaptiveAvgPool2d on NCHW is the same bins
    ref = torch.nn.AdaptiveAvgPool2d(out)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got, ref.permute(0, 2, 3, 1).numpy(), rtol=0, atol=1e-6)


COMBOS = [("object_presence", "clip_avgpool"), ("object_presence", "clip_attnpool"),
          ("reachability", "imagenet_avgpool"), ("free_space", "clip_attnpool"),
          ("object_localization", "clip_avgpool")]


def _inputs(prediction_type, n=16, d=24, seed=0):
    rng = np.random.RandomState(seed)
    if prediction_type == "object_localization":
        return rng.randn(n, 7, 7, d).astype(np.float32)
    return rng.randn(n, d).astype(np.float32)


def _labels(prediction_type, n=16, seed=1):
    rng = np.random.RandomState(seed)
    if prediction_type == "object_presence":
        return (rng.rand(n, 52) > 0.8).astype(np.int64)
    if prediction_type == "object_localization":
        return (rng.rand(n, 9, 52) > 0.9).astype(np.int64)
    if prediction_type == "reachability":
        return rng.randint(0, 110, n).astype(np.int32), rng.randint(0, 2, n).astype(np.int32)
    y = rng.randint(0, 14, n).astype(np.int64)  # above MAX_FORWARD_STEPS: clipped to 10
    assert (y > 10).any()
    return y


def _jax_and_port(prediction_type, embedding_type, x):
    jmod = jp.build_probe(embedding_type, prediction_type)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    pmod = pp.build_probe(embedding_type, prediction_type, in_features=x.shape[-1])
    pmod.load_state_dict(from_flax_probe_params(jax.tree.map(np.asarray, params)))
    return jmod, params, pmod


def _t(y):
    return tuple(torch.from_numpy(v) for v in y) if isinstance(y, tuple) else torch.from_numpy(y)


def _j(y):
    return tuple(jnp.asarray(v) for v in y) if isinstance(y, tuple) else jnp.asarray(y)


@pytest.mark.parametrize("prediction_type,embedding_type", COMBOS)
def test_probe_logits_loss_metrics_match_jax(prediction_type, embedding_type):
    x = _inputs(prediction_type)
    y = _labels(prediction_type)
    jmod, params, pmod = _jax_and_port(prediction_type, embedding_type, x)
    want = np.array(jmod.apply({"params": params}, jnp.asarray(x)))
    got = pmod(torch.from_numpy(x))
    shape = {"object_presence": (16, 52), "reachability": (16, 110), "free_space": (16, 11),
             "object_localization": (16, 9, 52)}[prediction_type]
    assert tuple(got.shape) == want.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)

    logits = torch.from_numpy(want)  # the same logits into both losses
    loss = float(pp.probe_loss(prediction_type, logits, _t(y)))
    jloss = float(jp.probe_loss(prediction_type, jnp.asarray(want), _j(y)))
    assert abs(loss - jloss) <= 1e-6, (loss, jloss)
    acc = float(pp.probe_metrics(prediction_type, logits, _t(y))["accuracy"])
    jacc = float(jp.probe_metrics(prediction_type, jnp.asarray(want), _j(y))["accuracy"])
    assert abs(acc - jacc) <= 1e-6, (acc, jacc)


def test_localization_accepts_grid_labels():
    """(N, 3, 3, 52) labels are the (N, 9, 52) cells, row-major."""
    x = _inputs("object_localization")
    y = _labels("object_localization")
    logits = torch.from_numpy(np.random.RandomState(4).randn(16, 9, 52).astype(np.float32))
    a = pp.probe_loss("object_localization", logits, torch.from_numpy(y))
    b = pp.probe_loss("object_localization", logits, torch.from_numpy(y.reshape(16, 3, 3, 52)))
    assert float(a) == float(b)
    assert x.shape == (16, 7, 7, 24)


def test_validate_combo_matches_jax():
    for pred in pp.PREDICTION_TYPES:
        for emb in pp.EMBEDDING_TYPES + ("imagenet_conv",):
            outcomes = []
            for mod in (jp, pp):
                try:
                    mod.validate_combo(emb, pred)
                    outcomes.append("ok")
                except AssertionError:
                    outcomes.append("AssertionError")
            assert outcomes[0] == outcomes[1], (emb, pred, outcomes)
    with pytest.raises(AssertionError):
        pp.build_probe("clip_attnpool", "object_localization")


def test_probe_init_is_flax_dense():
    """Truncated LeCun-normal kernel (|w| ≤ 2σ, σ = fan_in^-½ / 0.8796), zero bias, drawn
    from the generator: the same seed gives the same weights, on every build."""
    a = pp.build_probe("clip_avgpool", "object_presence",
                       generator=torch.Generator().manual_seed(1))
    b = pp.build_probe("clip_avgpool", "object_presence",
                       generator=torch.Generator().manual_seed(1))
    w = a.linear.weight.detach()
    assert tuple(w.shape) == (52, 2048)
    assert torch.equal(w, b.linear.weight) and not a.linear.bias.any()
    sigma = 2048 ** -0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * sigma
    assert abs(float(w.std()) - 2048 ** -0.5) < 0.02 * 2048 ** -0.5
    loc = pp.build_probe("imagenet_avgpool", "object_localization")
    assert tuple(loc.cell_linear.weight.shape) == (52, 2048)
    assert tuple(pp.build_probe("clip_attnpool", "free_space").linear.weight.shape) == (11, 1024)
