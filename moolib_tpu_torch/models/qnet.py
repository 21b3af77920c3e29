"""Recurrent Q-network for the R2D2 example (encoder → LSTM → dueling Q).

The port of the JAX package's ``models/qnet.py``.  Same call contract as
the other models: time-major input dict → ``({"q": [T,B,A]}, core_state)``.
``encoder="mlp"`` (default) consumes flat vector states; ``encoder="impala"``
consumes [T,B,H,W,C] uint8 frames through the IMPALA ResNet
(:class:`.impala.ImpalaEncoder`) — the classic R2D2-on-Atari shape (B=64
sequences of T=80 at 84×84×4).

Numerics follow the flax model:

- every parameter is f32; the encoder, ``Dense_0`` and ``Dense_1`` compute
  in ``dtype`` (frames cast as flax does: ``x.to(dtype) / 255``);
- the LSTM (flax's ``OptimizedLSTMCell`` under ``nn.scan``, here
  :class:`.impala.LSTMCore` under the name ``core``) runs in f32, its carry
  zeroed where ``done`` is set before each step;
- the dueling heads ``Dense_2`` (value) and ``Dense_3`` (advantage) run in
  f32: ``q = V + A - mean(A)``.

Module names are flax's, so :func:`.convert.qnet_from_flax` moves weights
across with no renaming beyond the LSTM's packing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve
from .impala import ImpalaEncoder, LSTMCore, init_flax_defaults
from .transformer import Dense


class RecurrentQNet(nn.Module):
    """The R2D2 network.  ``obs_shape`` sizes ``Dense_0`` (flax infers it
    from the first call): (H, W, C) frames for ``encoder="impala"``
    (default (84, 84, 4)), the state's shape for ``encoder="mlp"``
    (required).  Weights come from ``generator`` and live on ``device``
    (CUDA by default; pass ``device="cpu"`` to run on the CPU)."""

    def __init__(
        self,
        num_actions: int,
        hidden_size: int = 128,
        core_size: int = 64,
        use_lstm: bool = True,
        dtype: torch.dtype = torch.float32,
        encoder: str = "mlp",
        channels: Sequence[int] = (16, 32, 32),
        obs_shape: Optional[Sequence[int]] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if encoder not in ("mlp", "impala"):
            raise ValueError(f"unknown encoder {encoder!r}")
        dev = resolve(device)
        self.num_actions, self.use_lstm = num_actions, use_lstm
        self.core_size, self.dtype, self.encoder = core_size, dtype, encoder
        if encoder == "impala":
            h, w, c = obs_shape or (84, 84, 4)
            self.ImpalaEncoder_0 = ImpalaEncoder(c, channels, dtype, dev)
            for _ in channels:
                h, w = -(-h // 2), -(-w // 2)
            d_in = h * w * channels[-1]
        else:
            if obs_shape is None:
                raise ValueError("encoder='mlp' needs obs_shape, the state's shape")
            d_in = 1
            for n in obs_shape:
                d_in *= n
        self.Dense_0 = Dense(d_in, hidden_size, dtype, dev)
        self.Dense_1 = Dense(hidden_size, core_size, dtype, dev)
        self.core = LSTMCore(core_size, core_size, dev) if use_lstm else None
        self.Dense_2 = Dense(core_size, 1, torch.float32, dev)  # value
        self.Dense_3 = Dense(core_size, num_actions, torch.float32, dev)  # advantage
        init_flax_defaults(self, generator)

    @property
    def device(self) -> torch.device:
        return self.Dense_0.kernel.device

    def initial_state(self, batch_size: int) -> Tuple:
        """The LSTM carry (c, h), zeros of [B, core_size] f32; () without it."""
        if not self.use_lstm:
            return ()
        return tuple(torch.zeros(batch_size, self.core_size, device=self.device)
                     for _ in range(2))

    def forward(self, inputs, core_state=()):
        x = inputs["state"]
        T, B = x.shape[0], x.shape[1]
        if self.encoder == "impala":
            # NHWC frames viewed as NCHW: channels_last in memory, no copy.
            x = x.reshape(T * B, *x.shape[2:]).permute(0, 3, 1, 2)
            x = self.ImpalaEncoder_0(x.to(self.dtype) / 255.0)
            x = x.permute(0, 2, 3, 1).reshape(T * B, -1)  # flax's (h, w, c) flatten
        else:
            x = x.reshape(T * B, -1).to(self.dtype)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        if self.use_lstm:
            notdone = (~inputs["done"]).to(torch.float32)
            x, core_state = self.core(x.reshape(T, B, -1).to(torch.float32), notdone,
                                      tuple(core_state))
            x = x.reshape(T * B, -1)
        x = x.to(torch.float32)
        value, adv = self.Dense_2(x), self.Dense_3(x)
        q = value + adv - adv.mean(dim=-1, keepdim=True)
        return {"q": q.reshape(T, B, self.num_actions)}, core_state
