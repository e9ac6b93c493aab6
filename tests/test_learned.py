"""Learned-dynamics tests: architectures, residual composition, training loop,
in-graph jacobians (the l4casadi replacement), checkpoint round-trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dnn_mppi_mpc.models.dynamics import residual_dynamics, unicycle
from dnn_mppi_mpc.models.learned import (
    MLP,
    ResNet1D,
    Standardizer,
    make_residual_fn,
)
from dnn_mppi_mpc.train.training import TrainConfig, train_residual_model


def test_mlp_zero_init_head_outputs_zero():
    """dnn/simple_mlp.py:14-16: zero-initialized output layer → residual starts at 0."""
    model = MLP(out_dim=3)
    params = model.init(jax.random.PRNGKey(0), jnp.ones((2, 5)))
    out = model.apply(params, jnp.ones((2, 5)))
    np.testing.assert_allclose(np.asarray(out), 0.0, atol=1e-7)


def test_mlp_shapes_and_param_count():
    model = MLP(out_dim=3, hidden=512, depth=2)
    params = model.init(jax.random.PRNGKey(0), jnp.ones((1, 3)))
    n_params = sum(p.size for p in jax.tree.leaves(params))
    # 3→512, 512→512 ×2, 512→3 (dnn/simple_mlp.py layer stack)
    expected = (3 * 512 + 512) + 2 * (512 * 512 + 512) + (512 * 3 + 3)
    assert n_params == expected


@pytest.mark.parametrize("variant,feat", [("18", 5), ("50", 5)])
def test_resnet1d_forward_shape(variant, feat):
    model = ResNet1D(out_dim=3, variant=variant)
    x = jnp.ones((4, 1, feat))  # (B, L=1, C) — the reference feeds L=1 tensors
    variables = model.init(jax.random.PRNGKey(0), x)
    out = model.apply(variables, x)
    assert out.shape == (4, 3)
    assert np.all(np.abs(np.asarray(out)) <= 1.0)  # tanh head


def test_standardizer_roundtrip():
    data = jnp.asarray(np.random.default_rng(0).normal(2.0, 3.0, (100, 4)))
    sc = Standardizer.fit(data)
    z = sc.transform(data)
    np.testing.assert_allclose(np.asarray(jnp.mean(z, axis=0)), 0.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sc.inverse(z)), np.asarray(data), rtol=1e-5)


def test_residual_dynamics_composition_and_jacobian():
    """f = analytic + NN must be differentiable in-graph: jacfwd replaces the
    TorchScript jacrev traces of _l4c_generated/*.pt."""
    model = MLP(out_dim=3, hidden=32, depth=2, zero_init_head=False)
    params = model.init(jax.random.PRNGKey(1), jnp.ones((1, 5)))
    net = make_residual_fn(model, params)
    f = residual_dynamics(unicycle, net)

    x = jnp.array([0.1, 0.2, 0.3])
    u = jnp.array([1.0, 0.5])
    out = f(x, u)
    assert out.shape == (3,)

    A = jax.jacfwd(lambda s: f(s, u))(x)
    B = jax.jacfwd(lambda a: f(x, a))(u)
    assert A.shape == (3, 3) and B.shape == (3, 2)
    assert np.all(np.isfinite(np.asarray(A)))
    # hessian also available in-graph (replaces *_hess.pt)
    H = jax.hessian(lambda s: f(s, u).sum())(x)
    assert H.shape == (3, 3)


def test_training_learns_synthetic_residual():
    """The MLP must fit a known residual map to low MSE (train_diff_mlp.py loop)."""
    rng = np.random.default_rng(0)
    states = rng.normal(size=(2000, 3)).astype(np.float32)
    controls = rng.normal(size=(2000, 2)).astype(np.float32)
    # synthetic residual: linear + mild nonlinearity
    errors = (
        0.3 * states[:, :3]
        + 0.2 * np.sin(controls[:, :1])
        + 0.1 * controls[:, 1:2] * states[:, 1:2]
    ).astype(np.float32)

    model = MLP(out_dim=3, hidden=64, depth=2)
    state, hist = train_residual_model(
        model,
        jnp.asarray(states),
        jnp.asarray(controls),
        jnp.asarray(errors),
        TrainConfig(num_epochs=40, batch_size=256, learning_rate=1e-3),
    )
    assert hist["val_mse"][-1] < 0.05, hist["val_mse"][-5:]
    assert hist["val_mse"][-1] < hist["val_mse"][0]


def test_checkpoint_roundtrip(tmp_path):
    from dnn_mppi_mpc.train.checkpoint import load_checkpoint, save_checkpoint

    model = MLP(out_dim=3, hidden=16, depth=1)
    params = model.init(jax.random.PRNGKey(0), jnp.ones((1, 5)))
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, params)
    restored = load_checkpoint(path, params)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b)),
        params,
        restored,
    )


@pytest.mark.slow
def test_resnet18_residual_training_runs():
    """ResNet-1D regressor trains through the same loop (train_diff_resnet18.py
    equivalent): BatchNorm statistics threaded, loss decreases."""
    rng = np.random.default_rng(1)
    states = rng.normal(size=(800, 3)).astype(np.float32)
    controls = rng.normal(size=(800, 2)).astype(np.float32)
    errors = (0.3 * states + 0.1 * np.tanh(controls[:, :1])).astype(np.float32)

    model = ResNet1D(out_dim=3, variant="18")
    state, hist = train_residual_model(
        model,
        jnp.asarray(states),
        jnp.asarray(controls),
        jnp.asarray(errors),
        TrainConfig(num_epochs=3, batch_size=128, learning_rate=1e-3),
    )
    assert np.isfinite(hist["val_mse"][-1])
    assert hist["train_mse"][-1] < hist["train_mse"][0]


def test_full_train_state_checkpoint_roundtrip(tmp_path):
    """Checkpoint the complete training state (params + optimizer + scalers) —
    the resume capability the reference lacks (SURVEY §5.4)."""
    import dataclasses

    from dnn_mppi_mpc.train.checkpoint import load_checkpoint, save_checkpoint

    rng = np.random.default_rng(3)
    states = rng.normal(size=(300, 3)).astype(np.float32)
    controls = rng.normal(size=(300, 2)).astype(np.float32)
    errors = (0.2 * states).astype(np.float32)
    model = MLP(out_dim=3, hidden=16, depth=1)
    tstate, _ = train_residual_model(
        model,
        jnp.asarray(states),
        jnp.asarray(controls),
        jnp.asarray(errors),
        TrainConfig(num_epochs=2, batch_size=64),
    )
    tree = {
        "params": tstate.params,
        "opt_state": tstate.opt_state,
        "in_scaler": dataclasses.asdict(tstate.in_scaler),
        "out_scaler": dataclasses.asdict(tstate.out_scaler),
    }
    path = str(tmp_path / "full")
    save_checkpoint(path, tree)
    restored = load_checkpoint(path, tree)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b)),
        tree,
        restored,
    )


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")
def test_dp_sharded_training_runs():
    """Data-parallel training over the 'batch' mesh axis (SURVEY §2.10(d))."""
    from jax.sharding import Mesh

    rng = np.random.default_rng(0)
    states = rng.normal(size=(1600, 3)).astype(np.float32)
    controls = rng.normal(size=(1600, 2)).astype(np.float32)
    errors = (0.3 * states).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()).reshape(8), ("batch",))
    model = MLP(out_dim=3, hidden=32, depth=1)
    tstate, hist = train_residual_model(
        model,
        jnp.asarray(states),
        jnp.asarray(controls),
        jnp.asarray(errors),
        TrainConfig(num_epochs=5, batch_size=256),
        mesh=mesh,
    )
    assert hist["val_mse"][-1] < hist["val_mse"][0]
