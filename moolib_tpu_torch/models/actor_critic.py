"""Small recurrent actor-critic for vector observations (CartPole-class).

The port of the JAX package's ``models/actor_critic.py`` (reference
``examples/a2c.py:52-114``: FC → LSTM → policy + baseline heads), with the
call contract of :class:`.impala.ImpalaNet`.  Everything runs in f32; the
flax names are kept (``Dense_0``, ``Dense_1``; the heads are flax's
``Dense_2`` and ``Dense_3``, here ``policy`` and ``baseline``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .._device import resolve
from .impala import LSTMCore, heads_and_sample, init_flax_defaults
from .transformer import Dense


class ActorCriticNet(nn.Module):
    """Reference shape: FC-128 → FC-32 → (LSTM-32) → heads
    (``examples/a2c.py:55-66``).  ``obs_size`` is the flattened observation
    width, which sizes ``Dense_0`` (flax infers it from the first call)."""

    def __init__(
        self,
        num_actions: int,
        obs_size: int = 4,
        hidden_size: int = 128,
        core_size: int = 32,
        use_lstm: bool = True,
        dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve(device)
        self.num_actions, self.use_lstm = num_actions, use_lstm
        self.core_size, self.dtype = core_size, dtype
        self.Dense_0 = Dense(obs_size, hidden_size, dtype, dev)
        self.Dense_1 = Dense(hidden_size, core_size, dtype, dev)
        self.core = LSTMCore(core_size, core_size, dev) if use_lstm else None
        self.policy = Dense(core_size, num_actions, torch.float32, dev)
        self.baseline = Dense(core_size, 1, torch.float32, dev)
        self.sp = None  # as ImpalaNet.sp: a learner's time block over an sp axis
        init_flax_defaults(self, generator)

    @property
    def device(self) -> torch.device:
        return self.Dense_0.kernel.device

    def initial_state(self, batch_size: int) -> Tuple:
        if not self.use_lstm:
            return ()
        return tuple(torch.zeros(batch_size, self.core_size, device=self.device)
                     for _ in range(2))

    def forward(self, inputs, core_state=(), sample_generator: Optional[torch.Generator] = None):
        x = inputs["state"]
        T, B = x.shape[0], x.shape[1]
        if self.sp is not None:
            x = self.sp.local(x, dim=0)
        Tl = x.shape[0]
        x = x.reshape(Tl * B, -1).to(self.dtype)
        x = torch.tanh(self.Dense_0(x))
        x = torch.tanh(self.Dense_1(x))
        if self.sp is not None:
            x = self.sp.gather(x.reshape(Tl, B, -1), dim=0).reshape(T * B, -1)
        if self.use_lstm:
            notdone = (~inputs["done"]).to(torch.float32)
            x, core_state = self.core(x.reshape(T, B, -1).to(torch.float32), notdone,
                                      tuple(core_state))
            x = x.reshape(T * B, -1)
        out = heads_and_sample(self, x, T, B, sample_generator)
        return out, core_state
