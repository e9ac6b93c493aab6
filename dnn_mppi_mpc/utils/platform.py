"""The platform decision and the compile cache, each made in one place.

``platform()`` is the only place the program asks which machine it runs on:
the GPU kernels are chosen on ``"gpu"`` and the plain XLA paths elsewhere.
``enable_compilation_cache()`` is the only place a compile-cache directory is
chosen.
"""

from __future__ import annotations

import os

_SUPPORTED = ("gpu", "cpu")


def platform() -> str:
    """``"gpu"`` or ``"cpu"`` — the backend JAX runs this process on.

    Any other backend is an error: this program has kernels for NVIDIA GPUs
    and plain XLA paths, and nothing else."""
    import jax

    p = jax.default_backend()
    if p not in _SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX backend {p!r}: this program runs on 'gpu' "
            "(CUDA) or 'cpu'"
        )
    return p


def require_gpu() -> None:
    """Fail unless JAX runs on a GPU — measurement paths never fall back to
    the CPU."""
    if platform() != "gpu":
        raise RuntimeError(
            "no GPU found: this measurement runs on an NVIDIA GPU only "
            f"(JAX backend is {platform()!r})"
        )


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is. Otherwise the
    cache lives in ``<checkout>/.jax_cache`` (git-ignored), a fixed path, so
    a later run of the same checkout finds it again."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ".jax_cache",
    )
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # the default thresholds skip sub-second compiles; the test suite's cost
    # is the long tail of many ~1-10 s CPU compiles, so cache (almost) all
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir


__all__ = [
    "platform",
    "require_gpu",
    "enable_compilation_cache",
]
