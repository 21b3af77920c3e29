"""IMPALA deep ResNet policy network.

The port of the JAX package's ``models/impala.py`` (reference
``examples/atari/models.py:9-153``): 3 sections (16/32/32 channels by
default), each = conv3x3 → maxpool3x3/2 → two 2-conv residual blocks;
flatten → FC-256 → concat(clipped reward, one-hot prev action) → optional
LSTM with done-masked state resets → policy + baseline heads.

Call contract, time-major as in flax::

    inputs = {"state": [T,B,H,W,C] uint8, "reward": [T,B] f32,
              "done": [T,B] bool, "prev_action": [T,B] int}
    model(inputs, core_state, sample_generator=None)
      -> ({"policy_logits": [T,B,A] f32, "baseline": [T,B] f32,
           "action": [T,B] int64 (only with a generator)}, core_state)

Numerics follow the flax model:

- every parameter is f32 and the convs and ``Dense_0`` cast it and their
  input to ``dtype`` (bfloat16 by default) at use; the LSTM and both heads
  run in f32;
- frames are NHWC uint8.  They are viewed as NCHW without a copy, which
  leaves them ``channels_last`` in memory (cuDNN's fast bf16 layout), and
  cast as flax does: ``x.to(dtype) / 255`` with the division in ``dtype``;
- flax's ``max_pool(3, stride 2, "SAME")`` pads with −inf by a different
  amount at each size ((low 0, high 1) at 84 and 42, (1, 1) at 21), so the
  padding is computed per input size (:func:`same_pool_padding`) and applied
  before an unpadded pool; ``MaxPool2d(padding=1)`` would shift the windows;
- the flatten before ``Dense_0`` is in flax's (h, w, c) order: a free
  ``permute`` of the ``channels_last`` activations, so ``Dense_0``'s kernel
  rows need no permutation in the converter;
- the LSTM is flax's ``OptimizedLSTMCell`` under ``nn.scan``: carry (c, h),
  gates i, f, g, o (sigmoid, sigmoid, tanh, sigmoid), the input kernels
  without bias and the hidden ones with it, packed here into one kernel
  each; the carry is zeroed where ``done`` is set, before each step.

Sampling takes an explicit ``torch.Generator`` (Gumbel-max, no host sync);
``jax.random.categorical``'s draws cannot be reproduced, so parity is held
on logits and baselines with the actions fed in.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve
from .transformer import Dense


def same_pool_padding(size: int, window: int = 3, stride: int = 2) -> Tuple[int, int]:
    """(low, high) padding of a flax/XLA ``"SAME"`` pool along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool(x, (3, 3), strides=(2, 2), padding="SAME")`` on NCHW."""
    (hl, hh), (wl, wh) = same_pool_padding(x.shape[2]), same_pool_padding(x.shape[3])
    x = F.pad(x, (wl, wh, hl, hh), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (3, 3), padding="SAME", dtype=dtype)``: f32
    parameters cast to ``dtype`` at use.  ``kernel`` is torch's [out, in,
    kh, kw] (the converter transposes flax's [kh, kw, in, out]).  Cut over
    ``tp`` (``parallel.tensor_parallel.shard_model``) it computes its block
    of output channels and gathers them."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(d_out, d_in, 3, 3, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))
        self.tp = None  # cut over tp: the kernel's block of output channels

    def forward(self, x):
        kernel = self.kernel.to(self.dtype, memory_format=torch.channels_last)
        bias = self.bias.to(self.dtype)
        if self.tp is None:
            return F.conv2d(x.to(self.dtype), kernel, bias, padding=1)
        y = F.conv2d(x.to(self.dtype), kernel, self.tp.local(bias), padding=1)
        return self.tp.gather(y, 1)


class ResidualBlock(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.Conv_0 = Conv(channels, channels, dtype, device)
        self.Conv_1 = Conv(channels, channels, dtype, device)

    def forward(self, x):
        y = self.Conv_0(F.relu(x))
        y = self.Conv_1(F.relu(y))
        return x + y


class ImpalaEncoder(nn.Module):
    """Per section: ``Conv_{i}``, the pool, ``ResidualBlock_{2i}`` and
    ``ResidualBlock_{2i+1}`` (flax's names)."""

    def __init__(self, d_in: int, channels: Sequence[int], dtype: torch.dtype, device=None):
        super().__init__()
        self.num_sections = len(channels)
        for i, ch in enumerate(channels):
            setattr(self, f"Conv_{i}", Conv(d_in, ch, dtype, device))
            setattr(self, f"ResidualBlock_{2 * i}", ResidualBlock(ch, dtype, device))
            setattr(self, f"ResidualBlock_{2 * i + 1}", ResidualBlock(ch, dtype, device))
            d_in = ch

    def forward(self, x):
        for i in range(self.num_sections):
            x = max_pool_same(getattr(self, f"Conv_{i}")(x))
            x = getattr(self, f"ResidualBlock_{2 * i}")(x)
            x = getattr(self, f"ResidualBlock_{2 * i + 1}")(x)
        return F.relu(x)


class LSTMCore(nn.Module):
    """flax ``OptimizedLSTMCell`` scanned over time with done-masked resets.

    ``input_kernel`` packs flax's ``ii|if|ig|io`` kernels [in, 4H] and
    ``hidden_kernel`` its ``hi|hf|hg|ho`` kernels [H, 4H]; ``bias`` packs
    the hidden biases (the input kernels have none).  All f32."""

    def __init__(self, d_in: int, hidden: int, device=None):
        super().__init__()
        self.hidden = hidden
        self.input_kernel = nn.Parameter(torch.empty(d_in, 4 * hidden, device=device))
        self.hidden_kernel = nn.Parameter(torch.empty(hidden, 4 * hidden, device=device))
        self.bias = nn.Parameter(torch.zeros(4 * hidden, device=device))

    def forward(self, x, notdone, state):
        """``x`` [T, B, in] f32, ``notdone`` [T, B] f32, ``state`` (c, h)
        [B, H] each → (outputs [T, B, H], (c, h))."""
        xi = x @ self.input_kernel  # every step's input projection at once
        c, h = state
        outs = []
        for t in range(x.shape[0]):
            nd = notdone[t, :, None]
            c, h = c * nd, h * nd
            i, f, g, o = (h @ self.hidden_kernel + self.bias + xi[t]).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs), (c, h)


def init_flax_defaults(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """flax's default initialisers, drawn on the CPU from ``generator`` (a
    fresh one seeded 0 when None): conv and dense kernels and the LSTM's
    input kernel lecun-normal (truncated at 2 sigma, variance 1/fan_in), the
    LSTM's hidden kernel orthogonal per gate, biases 0."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def lecun(shape, fan_in):
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        w = torch.empty(shape)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
        return w

    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, Conv):
                mod.kernel.copy_(lecun(mod.kernel.shape, mod.kernel[0].numel()))
                mod.bias.zero_()
            elif isinstance(mod, Dense):
                mod.kernel.copy_(lecun(mod.kernel.shape, mod.kernel.shape[0]))
                mod.bias.zero_()
            elif isinstance(mod, LSTMCore):
                mod.input_kernel.copy_(lecun(mod.input_kernel.shape, mod.input_kernel.shape[0]))
                gates = [torch.empty(mod.hidden, mod.hidden) for _ in range(4)]
                for w in gates:
                    nn.init.orthogonal_(w, generator=generator)
                mod.hidden_kernel.copy_(torch.cat(gates, dim=1))
                mod.bias.zero_()


def heads_and_sample(model, core_output, T: int, B: int, generator) -> dict:
    """The two f32 heads (``policy``, ``baseline`` attributes of ``model``)
    and, with a generator, a categorical sample by Gumbel-max."""
    logits = model.policy(core_output).reshape(T, B, model.num_actions)
    out = {"policy_logits": logits, "baseline": model.baseline(core_output).reshape(T, B)}
    if generator is not None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        out["action"] = torch.argmax(logits.detach() + gumbel, dim=-1)
    return out


class ImpalaNet(nn.Module):
    """The IMPALA agent network (see module docstring).  ``obs_shape`` is
    (H, W, C), which sizes ``Dense_0`` (flax infers it from the first
    call).  Weights come from ``generator`` and live on ``device`` (CUDA by
    default; pass ``device="cpu"`` to run on the CPU)."""

    def __init__(
        self,
        num_actions: int,
        obs_shape: Sequence[int] = (84, 84, 4),
        channels: Sequence[int] = (16, 32, 32),
        use_lstm: bool = False,
        hidden_size: int = 256,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve(device)
        self.num_actions, self.use_lstm = num_actions, use_lstm
        self.hidden_size, self.dtype = hidden_size, dtype
        h, w, c = obs_shape
        self.ImpalaEncoder_0 = ImpalaEncoder(c, channels, dtype, dev)
        for _ in channels:
            h, w = -(-h // 2), -(-w // 2)
        self.Dense_0 = Dense(h * w * channels[-1], hidden_size, dtype, dev)
        core = hidden_size + 1 + num_actions
        self.core = LSTMCore(core, hidden_size, dev) if use_lstm else None
        d_head = hidden_size if use_lstm else core
        # flax's Dense_1 (policy) and Dense_2 (baseline), in f32.
        self.policy = Dense(d_head, num_actions, torch.float32, dev)
        self.baseline = Dense(d_head, 1, torch.float32, dev)
        # A learner's place on an sp mesh axis (parallel.tensor_parallel.TPShard
        # over "sp"): its encoder takes this rank's time block.
        self.sp = None
        init_flax_defaults(self, generator)

    @property
    def device(self) -> torch.device:
        return self.Dense_0.kernel.device

    def initial_state(self, batch_size: int) -> Tuple:
        if not self.use_lstm:
            return ()
        return tuple(torch.zeros(batch_size, self.hidden_size, device=self.device)
                     for _ in range(2))

    def forward(self, inputs, core_state=(), sample_generator: Optional[torch.Generator] = None):
        x = inputs["state"]
        T, B = x.shape[0], x.shape[1]
        if self.sp is not None:
            # Sequence parallelism: the frames of this rank's time block go
            # through the encoder and Dense_0, whose outputs are gathered
            # over sp (backward: the reduce-scatter); the core, the heads
            # and the loss see the whole unroll.
            x = self.sp.local(x, dim=0)
        Tl = x.shape[0]
        # NHWC frames viewed as NCHW: channels_last in memory, no copy.
        x = x.reshape(Tl * B, *x.shape[2:]).permute(0, 3, 1, 2)
        x = x.to(self.dtype) / 255.0
        x = self.ImpalaEncoder_0(x)
        x = x.permute(0, 2, 3, 1).reshape(Tl * B, -1)  # flax's (h, w, c) flatten
        x = F.relu(self.Dense_0(x))
        if self.sp is not None:
            x = self.sp.gather(x.reshape(Tl, B, -1), dim=0).reshape(T * B, -1)

        one_hot_prev = F.one_hot(inputs["prev_action"].reshape(T * B).long(),
                                 self.num_actions).to(self.dtype)
        clipped_reward = inputs["reward"].clamp(-1, 1).reshape(T * B, 1).to(self.dtype)
        core_input = torch.cat([x, clipped_reward, one_hot_prev], dim=-1)

        if self.use_lstm:
            notdone = (~inputs["done"]).to(torch.float32)
            core_output, core_state = self.core(
                core_input.reshape(T, B, -1).to(torch.float32), notdone, tuple(core_state))
            core_output = core_output.reshape(T * B, -1)
        else:
            core_output = core_input
        # Heads in float32 for stable logits/values.
        out = heads_and_sample(self, core_output.to(torch.float32), T, B, sample_generator)
        return out, core_state
