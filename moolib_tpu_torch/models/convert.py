"""Weight conversion from the JAX package's flax models.

TransformerLM
-------------
:func:`from_flax` turns a flax parameter tree (nested dicts of numpy
arrays, with or without the top-level ``"params"`` key) into a
``state_dict`` for :class:`.transformer.TransformerLM`.  The port's module
names mirror flax's (``embed``, ``pos``, ``block{i}`` → ``blocks.{i}``,
``LayerNorm_0``, ``qkv``, ``proj``, ``LayerNorm_1``, ``Dense_0``,
``Dense_1``, ``ln_f``, ``lm_head``) and its Dense layers keep flax's
``kernel`` [in, out] layout, so no tensor is transposed.  The fused ``qkv``
columns stay head-major in ``[H q, Hk k, Hk v]`` order, which is the order
the port's Block splits them in.  Every parameter of the port is f32, as
flax's are, so a converted tree loads without rounding; the layers that
compute in bf16 round at use, as flax does.  A flax *gradient* tree has the
same structure and converts the same way (the tests compare gradients by
name through it).  :func:`to_flax` is the inverse: the port's weights as
the flax variables tree ``{"params": ...}`` of f32 numpy leaves, keys
sorted at every level as ``jax.device_get`` leaves them.  Published serving
weights travel in that form, so a JAX replica hot-swaps to weights from a
port trainer and the reverse.

ImpalaNet and ActorCriticNet
----------------------------
:func:`impala_from_flax` and :func:`actor_critic_from_flax` do the same for
the RL models.  The port keeps flax's module names (``ImpalaEncoder_0``,
``Conv_{i}``, ``ResidualBlock_{j}``, ``Dense_0``, ``Dense_1``) with two
changes: the heads are ``policy`` and ``baseline`` (flax's last two Dense
layers), and the LSTM is ``core``, whose ``input_kernel`` packs flax's
``ii|if|ig|io`` kernels, ``hidden_kernel`` its ``hi|hf|hg|ho`` kernels and
``bias`` the hidden biases, in that gate order (flax's
``OptimizedLSTMCell`` packs them the same way before its two matmuls).  A
conv kernel [kh, kw, in, out] becomes torch's [out, in, kh, kw]; both
libraries compute cross-correlation, so nothing is flipped.  ``Dense_0``'s
rows stay in flax's (h, w, c) order: the port flattens its activations in
that order.  Gradient trees convert the same way.

RecurrentQNet
-------------
:func:`qnet_from_flax` does the same for the R2D2 network, whose port
keeps every flax name (``ImpalaEncoder_0`` with ``encoder="impala"``,
``Dense_0`` … ``Dense_3``); only ``Scan_Core_0`` becomes the packed
``core``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def from_flax(params) -> Dict[str, torch.Tensor]:
    """Flax ``TransformerLM`` params (nested numpy dicts) → ``state_dict``."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for name, value in tree.items():
            if name.startswith("block") and name[len("block"):].isdigit():
                name = f"blocks.{name[len('block'):]}"
            key = f"{prefix}{name}"
            if isinstance(value, dict):
                walk(value, key + ".")
            else:
                out[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    walk(params, "")
    return out


def as_state_dict(params) -> Dict[str, torch.Tensor]:
    """Published weights → a ``TransformerLM`` ``state_dict``: a flax tree
    (``{"params": ...}`` or the bare nested dict, numpy leaves, as either
    package's ``ModelPublisher`` carries it) goes through :func:`from_flax`;
    a ``state_dict`` passes through."""
    if "params" in params or any(isinstance(v, dict) for v in params.values()):
        return from_flax(params)
    return params


def to_flax(model_or_state_dict) -> Dict[str, dict]:
    """A ``TransformerLM`` (or its ``state_dict``) → the flax variables tree
    ``{"params": {...}}`` with f32 numpy leaves, no transpose."""
    sd = model_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    tree: dict = {}
    for key, value in sd.items():
        parts = key.split(".")
        if parts[0] == "blocks":
            parts = [f"block{parts[1]}"] + parts[2:]
        node = tree
        for name in parts[:-1]:
            node = node.setdefault(name, {})
        node[parts[-1]] = value.detach().to(device="cpu", dtype=torch.float32).numpy()

    def sort(node):
        return {k: sort(v) if isinstance(v, dict) else v for k, v in sorted(node.items())}

    return {"params": sort(tree)}


_GATES = ("i", "f", "g", "o")


def _rl_from_flax(params, heads) -> Dict[str, torch.Tensor]:
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def walk(tree, prefix):
        for name, value in tree.items():
            key = f"{prefix}{heads.get(name, name)}"
            if isinstance(value, dict):
                walk(value, key + ".")
            elif name == "kernel" and np.ndim(value) == 4:
                out[key] = f32(value).permute(3, 2, 0, 1).contiguous()
            else:
                out[key] = f32(value)

    params = dict(params)
    core = params.pop("Scan_Core_0", None)
    walk(params, "")
    if core is not None:
        cell = core["OptimizedLSTMCell_0"]
        out["core.input_kernel"] = torch.cat([f32(cell[f"i{g}"]["kernel"]) for g in _GATES], 1)
        out["core.hidden_kernel"] = torch.cat([f32(cell[f"h{g}"]["kernel"]) for g in _GATES], 1)
        out["core.bias"] = torch.cat([f32(cell[f"h{g}"]["bias"]) for g in _GATES])
    return out


def impala_from_flax(params) -> Dict[str, torch.Tensor]:
    """Flax ``ImpalaNet`` params (or gradients) → ``state_dict`` of
    :class:`.impala.ImpalaNet`."""
    return _rl_from_flax(params, {"Dense_1": "policy", "Dense_2": "baseline"})


def actor_critic_from_flax(params) -> Dict[str, torch.Tensor]:
    """Flax ``ActorCriticNet`` params (or gradients) → ``state_dict`` of
    :class:`.actor_critic.ActorCriticNet`."""
    return _rl_from_flax(params, {"Dense_2": "policy", "Dense_3": "baseline"})


def qnet_from_flax(params) -> Dict[str, torch.Tensor]:
    """Flax ``RecurrentQNet`` params (or gradients) → ``state_dict`` of
    :class:`.qnet.RecurrentQNet`."""
    return _rl_from_flax(params, {})
