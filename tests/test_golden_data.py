"""Golden-trace integration: train the residual MLP on the reference's actual
recorded dataset (saved_data/*.npy — the 4149-sample Husky NMPC run produced by
train/bullet_mpc_differential_drive.py:334-336).

Skipped when the reference checkout is not present. This validates that the
JAX pipeline consumes the reference's real data layout end-to-end and reaches
a low validation MSE, standing in for the train_diff_mlp.py run whose final
metrics the reference never recorded (BASELINE.md).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

REF = "/root/reference/saved_data"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference saved_data not available"
)


def _load():
    states = np.load(os.path.join(REF, "states_diff.npy"))
    controls = np.load(os.path.join(REF, "controls_diff.npy"))
    errors = np.load(os.path.join(REF, "errors_diff.npy"))
    return states, controls, errors


def test_reference_trace_shapes():
    states, controls, errors = _load()
    assert states.shape == (4149, 3)
    assert controls.shape == (4149, 2)
    assert errors.shape == (4149, 3)
    assert states.dtype == np.float64


@pytest.mark.slow
def test_train_residual_on_reference_trace():
    from dnn_mppi_mpc.models.learned import MLP
    from dnn_mppi_mpc.train.training import TrainConfig, train_residual_model

    states, controls, errors = _load()
    model = MLP(out_dim=3, hidden=128, depth=2)
    tstate, hist = train_residual_model(
        model,
        jnp.asarray(states, jnp.float32),
        jnp.asarray(controls, jnp.float32),
        jnp.asarray(errors, jnp.float32),
        TrainConfig(num_epochs=25, batch_size=256, learning_rate=1e-3),
    )
    # targets are standardized → MSE of 1.0 == predicting the mean; the net
    # must explain a substantial share of the variance of the real data
    assert hist["val_mse"][-1] < 0.5, hist["val_mse"][-5:]
    assert hist["val_mse"][-1] < hist["val_mse"][0]
