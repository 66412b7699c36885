"""Shared helpers of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py)."""

import dataclasses

import numpy as np
import torch

from yume_tpu_torch import configs as port_configs

_NORM_LEAVES = ("weight", "gamma", "scale")


def perturb(tree, seed: int):
    """Replace every leaf of a JAX parameter tree (arrays, or shapes from
    ``jax.eval_shape``) with seeded noise: norm
    weights 1 + 0.1·N(0, 1), everything else 0.1·N(0, 1). Zero-initialised
    layers (the DiT head, the VAE attention projection) would otherwise make
    a parity test pass on biases alone."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        shape = tuple(node.shape)
        noise = 0.1 * rng.standard_normal(shape).astype(np.float32)
        is_norm = path[-1] in _NORM_LEAVES and any("norm" in p for p in path)
        return noise + 1.0 if is_norm else noise

    return walk(tree, ())


def to_np(x):
    """torch tensor or JAX array → float32 numpy."""
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=tol, rtol=0)


def port_config(cfg):
    """The port's copy of a JAX config dataclass (``yume_tpu.configs``),
    field for field, nested configs included; tuples stay tuples."""
    cls = getattr(port_configs, type(cfg).__name__)
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kw[f.name] = port_config(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)
