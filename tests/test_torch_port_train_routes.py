"""The training step of the PyTorch port against the JAX package on two more
routes: `mask_dynamic` with a dynamic-object mask at 32 x 64, and
`use_pallas_warp` at 48 x 384, inside the JAX package's gate, where the JAX
step runs its Pallas warp (K1a) in interpret mode and the port runs K1's
plain version.  The checks are `test_torch_port_train.py`'s, on these
routes' fixture (each package's gradients against the port's float64 step
too); they have a file of their own so that each file stays near
a minute on one worker.
"""
import pytest

from test_torch_port_train import (  # noqa: F401  (collected here on this fixture)
    _run,
    test_gradients_against_float64,
    test_train_step_bn_running_statistics,
    test_train_step_losses_and_gradients,
    test_train_step_parameters_after_two_steps,
)


@pytest.fixture(scope="module", params=["mask_dynamic", "pallas_warp"])
def run(request):
    return request.param, _run(request.param)
