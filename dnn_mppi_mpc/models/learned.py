"""Learned dynamics in Flax — the in-graph replacement for l4casadi/TorchScript.

The reference embeds torch nets into CasADi via generated C++ shims and traced
jacobians (`_l4c_generated/learned_dynamics_differential_drive.cpp:39-52`); in
JAX the net is just a function, so NMPC linearization uses jax.jacfwd/hessian
directly (SURVEY §2.9). Architectures mirrored:

* :class:`MLP` — dnn/simple_mlp.py:5-24 (in→512, 2×(512→512, tanh), 512→out,
  zero-initialized output layer so the residual starts at 0) and the 5→512×2→3
  variant of simulation/bullet_differential_drive_dnn.py:37-60.
* :class:`ResNet1D` — the 1-D conv ResNet-18/50 of dnn/resnet18.py /
  dnn/resnet50.py (BasicBlock / BottleNeck over (B, C, L) with tanh head).
* :class:`Standardizer` — sklearn StandardScaler folded in-graph, the
  approach the reference itself validates at test/test_diff_dyna_eval.py:50-56.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import flax.linen as nn
import jax
import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class


class MLP(nn.Module):
    """tanh MLP with zero-init head (residual-dynamics regressor).

    Defaults replicate dnn/simple_mlp.py: hidden=512, depth=2 tanh hidden
    layers; note the reference applies NO activation after the input layer
    (simple_mlp.py:19-22: x = input_layer(x); then tanh(hidden(x))...).
    """

    out_dim: int = 3
    hidden: int = 512
    depth: int = 2
    zero_init_head: bool = True

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        x = nn.Dense(self.hidden)(x)
        for _ in range(self.depth):
            x = jnp.tanh(nn.Dense(self.hidden)(x))
        head_init = (
            nn.initializers.zeros if self.zero_init_head else nn.initializers.lecun_normal()
        )
        x = nn.Dense(
            self.out_dim, kernel_init=head_init, bias_init=nn.initializers.zeros
        )(x)
        return x


class BasicBlock1D(nn.Module):
    """ResNet-18 basic block over 1-D feature maps (dnn/resnet18.py:5-29)."""

    planes: int
    stride: int = 1

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False) -> jnp.ndarray:
        residual = x
        y = nn.Conv(self.planes, (3,), strides=(self.stride,), padding=1, use_bias=False)(x)
        y = nn.BatchNorm(use_running_average=not train)(y)
        y = nn.relu(y)
        y = nn.Conv(self.planes, (3,), strides=(1,), padding=1, use_bias=False)(y)
        y = nn.BatchNorm(use_running_average=not train)(y)
        if self.stride != 1 or x.shape[-1] != self.planes:
            residual = nn.Conv(
                self.planes, (1,), strides=(self.stride,), use_bias=False
            )(x)
            residual = nn.BatchNorm(use_running_average=not train)(residual)
        return nn.relu(y + residual)


class BottleneckBlock1D(nn.Module):
    """ResNet-50 bottleneck block over 1-D feature maps (dnn/resnet50.py:6-41)."""

    planes: int
    stride: int = 1
    expansion: int = 4

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False) -> jnp.ndarray:
        out_planes = self.planes * self.expansion
        residual = x
        y = nn.Conv(self.planes, (1,), use_bias=False)(x)
        y = nn.BatchNorm(use_running_average=not train)(y)
        y = nn.relu(y)
        y = nn.Conv(self.planes, (3,), strides=(self.stride,), padding=1, use_bias=False)(y)
        y = nn.BatchNorm(use_running_average=not train)(y)
        y = nn.relu(y)
        y = nn.Conv(out_planes, (1,), use_bias=False)(y)
        y = nn.BatchNorm(use_running_average=not train)(y)
        if self.stride != 1 or x.shape[-1] != out_planes:
            residual = nn.Conv(
                out_planes, (1,), strides=(self.stride,), use_bias=False
            )(x)
            residual = nn.BatchNorm(use_running_average=not train)(residual)
        return nn.relu(y + residual)


class ResNet1D(nn.Module):
    """1-D conv ResNet over (B, L, C) with tanh regression head.

    ``variant='18'`` mirrors dnn/resnet18.py:31-69 (BasicBlock ×[2,2,2,2],
    3-wide stem, avg-pool, linear, tanh); ``variant='50'`` mirrors
    dnn/resnet50.py:44-105 (BottleNeck ×[3,4,6,3], 7-wide stride-2 stem with
    max-pool). Inputs follow Flax channel-last convention: the reference's
    (B, C=input_dim, L) tensors transpose to (B, L, input_dim).
    """

    out_dim: int
    variant: str = "18"

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False) -> jnp.ndarray:
        if self.variant == "18":
            blocks, block_cls = [2, 2, 2, 2], BasicBlock1D
            x = nn.Conv(64, (3,), strides=(1,), padding=1, use_bias=False)(x)
            x = nn.relu(nn.BatchNorm(use_running_average=not train)(x))
        elif self.variant == "50":
            blocks, block_cls = [3, 4, 6, 3], BottleneckBlock1D
            x = nn.Conv(64, (7,), strides=(2,), padding=3, use_bias=False)(x)
            x = nn.relu(nn.BatchNorm(use_running_average=not train)(x))
            x = nn.max_pool(x, (3,), strides=(2,), padding=((1, 1),))
        else:
            raise ValueError(f"unknown variant {self.variant!r}")

        for stage, n_blocks in enumerate(blocks):
            planes = 64 * (2**stage)
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                x = block_cls(planes=planes, stride=stride)(x, train=train)

        x = jnp.mean(x, axis=-2)  # adaptive average pool over length
        x = nn.Dense(self.out_dim)(x)
        return jnp.tanh(x)


@register_pytree_node_class
@dataclasses.dataclass
class Standardizer:
    """StandardScaler folded in-graph (test/test_diff_dyna_eval.py:50-56).

    ``transform`` maps raw features to z-scores; ``inverse`` maps network
    outputs back to physical units — both pure array ops that live inside the
    jitted dynamics, replacing the pickled sklearn scalers of
    train/train_diff_mlp.py:179-189.
    """

    mean: jnp.ndarray
    std: jnp.ndarray

    def tree_flatten(self):
        return (self.mean, self.std), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def fit(cls, data: jnp.ndarray) -> "Standardizer":
        return cls(mean=jnp.mean(data, axis=0), std=jnp.std(data, axis=0) + 1e-8)

    def transform(self, x: jnp.ndarray) -> jnp.ndarray:
        return (x - self.mean) / self.std

    def inverse(self, z: jnp.ndarray) -> jnp.ndarray:
        return z * self.std + self.mean


def _bn_affine(bn_params, bn_stats, eps: float = 1e-5):
    """Inference BatchNorm as an affine pair (scale, shift)."""
    s = bn_params["scale"] / jnp.sqrt(bn_stats["var"] + eps)
    return s, bn_params["bias"] - bn_stats["mean"] * s


def fold_resnet1d_l1_arrays(model: "ResNet1D", variables):
    """The folded (stem, blocks, head) weight arrays of the L=1 dense chain.

    The extraction behind :func:`fold_resnet1d_l1` (XLA matmul chain). Returns
    ``(stem, blocks, head)`` where stem/head are (W, b) pairs and blocks is
    a list of ``(convs, down)`` with convs a list of (W, b) and down an
    optional (W, b).
    """
    p = variables["params"]
    st = variables.get("batch_stats", {})

    def conv_bn(pp, ss, i):
        W = pp[f"Conv_{i}"]["kernel"]  # (k, c_in, c_out)
        Wc = W[W.shape[0] // 2]
        s, b = _bn_affine(pp[f"BatchNorm_{i}"], ss[f"BatchNorm_{i}"])
        return Wc * s[None, :], b

    if model.variant == "18":
        block_prefix, n_blocks, n_convs = "BasicBlock1D", 8, 2
    elif model.variant == "50":
        block_prefix, n_blocks, n_convs = "BottleneckBlock1D", 16, 3
    else:
        raise ValueError(f"unknown variant {model.variant!r}")

    stem = conv_bn(p, st, 0)
    blocks = []
    for i in range(n_blocks):
        bp = p[f"{block_prefix}_{i}"]
        bs = st[f"{block_prefix}_{i}"]
        convs = [conv_bn(bp, bs, c) for c in range(n_convs)]
        down = conv_bn(bp, bs, n_convs) if f"Conv_{n_convs}" in bp else None
        blocks.append((convs, down))
    head = (p["Dense_0"]["kernel"], p["Dense_0"]["bias"])
    return stem, blocks, head


def fold_resnet1d_l1(
    model: "ResNet1D", variables, compute_dtype=None
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Constant-fold a ResNet1D at L=1 into a pure dense-matmul chain.

    The reference (and this port) runs the conv ResNets on LENGTH-1 inputs —
    the state vector with a fake length axis (dnn/resnet18.py:79-82,
    train/train_diff_resnet18.py:30-35). At L=1 every Conv1d sees exactly one
    input element: with kernel width k and padding k//2 (all the convs used
    here), only the CENTER tap multiplies real data — the rest hit zero
    padding — so each conv IS a dense matmul by its center-tap slice, the
    stride-2 stem and max-pool are identities (flax pads max_pool with −inf),
    and the adaptive average pool is a no-op. Inference BatchNorm is affine
    and folds into the adjacent matmul. This function extracts the folded
    (W', b') chain ONCE at bind time and returns a (B, C) → (B, out)
    function that is a plain chain of matrix products. Exact-equivalence
    gate: tests/test_resnet_dynamics.py::test_folded_resnet_matches_conv_path.

    XLA may already simplify the L=1 conv graph to the same matrix
    products; whether the fold moves throughput on a GPU is not measured.
    ``compute_dtype=jnp.bfloat16`` casts the weights once at fold time and
    runs the chain in bf16 with an f32 head output. Default f32 preserves
    exact conv-path parity.
    """
    dt = compute_dtype
    stem, blocks, (head_W, head_b) = fold_resnet1d_l1_arrays(model, variables)
    if dt is not None:
        cast = lambda wb: (wb[0].astype(dt), wb[1].astype(dt))
        stem = cast(stem)
        blocks = [
            ([cast(c) for c in convs], cast(down) if down is not None else None)
            for convs, down in blocks
        ]
        head_W, head_b = head_W.astype(dt), head_b.astype(dt)

    def f(x: jnp.ndarray) -> jnp.ndarray:
        out_dtype = x.dtype
        if dt is not None:
            x = x.astype(dt)
        h = nn.relu(x @ stem[0] + stem[1])
        for convs, down in blocks:
            r = h if down is None else h @ down[0] + down[1]
            y = h
            for c, (W, b) in enumerate(convs):
                y = y @ W + b
                if c < len(convs) - 1:
                    y = nn.relu(y)
            h = nn.relu(y + r)
        y = jnp.tanh(h @ head_W + head_b)
        return y.astype(out_dtype) if dt is not None else y

    return f


def make_residual_fn(
    model: nn.Module,
    params,
    in_scaler: Optional[Standardizer] = None,
    out_scaler: Optional[Standardizer] = None,
    needs_length_axis: bool = False,
    compute_dtype=None,
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Bind a Flax module into a plain feature→residual function.

    The returned closure is what :func:`models.dynamics.residual_dynamics`
    composes with analytic dynamics — the role of
    ``l4c.L4CasADi(model, model_expects_batch_dim=True)``
    (simulation/bullet_differential_drive_dnn.py:288-292) with scalers folded
    in-graph. ``needs_length_axis`` inserts the L=1 axis the conv ResNets
    expect (the reference feeds (B, C, 1) tensors, dnn/resnet18.py:79-82).
    """

    folded = None
    if needs_length_axis:
        # conv ResNet on L=1 inputs: fold the whole network into a dense
        # matmul chain once at bind time (see fold_resnet1d_l1)
        folded = fold_resnet1d_l1(model, params, compute_dtype=compute_dtype)

    def f(feats: jnp.ndarray) -> jnp.ndarray:
        z = in_scaler.transform(feats) if in_scaler is not None else feats
        batch_shape = z.shape[:-1]
        z2 = z.reshape((-1, z.shape[-1]))
        if folded is not None:
            out = folded(z2)
        else:
            if needs_length_axis:
                z2 = z2[:, None, :]  # (B, L=1, C)
            out = model.apply(params, z2)
        out = out.reshape(batch_shape + (out.shape[-1],))
        return out_scaler.inverse(out) if out_scaler is not None else out

    return f


def residual_from_train_state(model: nn.Module, tstate) -> Callable:
    """Bind a trained model + its scalers into a feature→residual function.

    One call covers both model families: conv ResNets (``model.variant`` set)
    get the L=1 length axis inserted automatically — the detail the reference
    handles by tiling the state into fake images (train/train_diff_resnet18.py
    :30-35). ``tstate`` is a :class:`~..train.training.TrainState` (its
    ``params`` already carry BatchNorm running stats for ResNets; inference
    uses them frozen, which is what jacfwd linearizes through in NMPC).
    """
    return make_residual_fn(
        model,
        tstate.params,
        tstate.in_scaler,
        tstate.out_scaler,
        needs_length_axis=getattr(model, "variant", None) is not None,
    )


__all__ = [
    "MLP",
    "fold_resnet1d_l1",
    "BasicBlock1D",
    "BottleneckBlock1D",
    "ResNet1D",
    "Standardizer",
    "make_residual_fn",
    "residual_from_train_state",
]
