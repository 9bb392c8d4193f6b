"""The registry's policies across packages, habitat and rearrangement names (the
ObjectNav names are in test_torch_registry_policies.py): the JAX package's
`_build_policy(env)` parameters load strictly into the port's `_build_policy(env)`, and
one policy step on the same observations agrees within atol 1e-5.
"""

import pytest

from embodied_clip_tpu_torch.config import experiments as pexp
from torch_registry_cases import check_policy_agrees, one_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_thread()

NAMES = [n for n in pexp.list_experiments()
         if "robothor" not in n and not n.startswith("probe_")]


@pytest.mark.parametrize("name", NAMES)
def test_registry_policy_loads_jax_params_and_agrees(name):
    check_policy_agrees(name)
