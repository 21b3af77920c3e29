"""Weight conversion from the JAX package's flax TransformerLM.

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
name through it).
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
