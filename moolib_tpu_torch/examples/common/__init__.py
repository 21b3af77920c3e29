"""Shared example plumbing: the port of the JAX package's
``examples/common`` flag parsing, and the optax optimizers the JAX
examples write inline (``optax.rmsprop``, ``optax.adam``,
``optax.clip_by_global_norm``, ``optax.chain``) in optax 0.2.6's own
arithmetic.  The cohort stats accumulator, the per-actor-batch state and
the TSV logger come with the cohort slice."""

from __future__ import annotations

from typing import Iterable, List

import torch

from ...utils.config import Config


def finalize_flags(parser, argv=None):
    """Parse example-agent flags the hydra-ish way (reference agents use
    hydra; ``examples/vtrace/experiment.py:214-224``): argparse ``--flags``
    provide defaults and ``--help``; an optional ``--cfg config.yaml``
    overlays a file; trailing positional ``key=value`` overrides win.
    Returns a :class:`moolib_tpu_torch.utils.config.Config` (attribute
    access, interpolation, ``to_yaml``)."""
    import argparse as _argparse

    if not any(a.dest == "cfg" for a in parser._actions):  # idempotent
        parser.add_argument("--cfg", default=None, help="YAML config file overlay")
        parser.add_argument(
            "overrides", nargs="*", metavar="key=value", help="config overrides"
        )
    ns = parser.parse_args(argv)
    data = vars(ns)
    cfg_path = data.pop("cfg")
    kv_overrides = data.pop("overrides")
    # Priority: parser defaults < config file < explicit --flags < key=value.
    # argparse can't distinguish explicit values after one parse, so parse a
    # second time with every default suppressed to learn which flags the
    # user actually typed.
    saved = [(a, a.default) for a in parser._actions]
    try:
        for a, _ in saved:
            if a.dest != "help":
                a.default = _argparse.SUPPRESS
        explicit = vars(parser.parse_known_args(argv)[0])
    finally:
        for a, default in saved:
            a.default = default
    explicit.pop("cfg", None)
    explicit.pop("overrides", None)
    cfg = Config.load(cfg_path, defaults=data)
    for k, v in explicit.items():
        cfg[k] = v
    for ov in kv_overrides:
        cfg.apply_override(ov)
    return cfg


# ---------------------------------------------------------------- optimizers
#
# optax's gradient transformations over lists of tensors, with
# torch._foreach_* (a handful of launches an update, no host sync).  Each has
# ``init(params) -> state`` and ``update(updates, state) -> updates``, which
# may rewrite ``updates`` (the gradients, on entry) in place;
# :class:`OptaxOptimizer` chains them over a module's parameters.  torch.optim.RMSprop may not stand
# in for rmsprop: it adds eps outside the square root.


class clip_by_global_norm:  # noqa: N801 - optax's name
    """optax ``clip_by_global_norm``: where the global norm g is at least
    ``max_norm``, every update becomes ``(u / g) * max_norm``; below it,
    updates pass unchanged.  Decided on the device."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def init(self, params):
        return None

    def update(self, updates: List[torch.Tensor], state) -> List[torch.Tensor]:
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(updates)))
        clip = g_norm >= self.max_norm
        one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
        torch._foreach_div_(updates, torch.where(clip, g_norm, one))
        torch._foreach_mul_(updates, torch.where(clip, self.max_norm, one))
        return updates


class rmsprop:  # noqa: N801 - optax's name
    """optax 0.2.6 ``rmsprop(learning_rate, decay, eps)``: ``nu = decay * nu
    + (1 - decay) * g**2`` from ``initial_scale`` 0, then ``-lr * g *
    rsqrt(nu + eps)``: eps inside the square root (``eps_in_sqrt=True``)."""

    def __init__(self, learning_rate: float, decay: float = 0.9, eps: float = 1e-8):
        self.lr, self.decay, self.eps = learning_rate, decay, eps

    def init(self, params):
        return [torch.zeros_like(p) for p in params]

    def update(self, updates: List[torch.Tensor], nu) -> List[torch.Tensor]:
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, updates, updates, value=1 - self.decay)
        scaling = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(scaling)
        torch._foreach_mul_(updates, scaling)
        torch._foreach_mul_(updates, -self.lr)
        return updates


class adam:  # noqa: N801 - optax's name
    """optax ``adam(learning_rate, b1, b2, eps)`` (``eps_root`` 0):
    bias-corrected moments, ``-lr * mu_hat / (sqrt(nu_hat) + eps)``.  The
    step count is a host integer, so the bias corrections are scalars."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(self, updates: List[torch.Tensor], state) -> List[torch.Tensor]:
        mu, nu = state["mu"], state["nu"]
        state["count"] += 1
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, updates, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, updates, updates, value=1 - self.b2)
        out = torch._foreach_div(mu, 1 - self.b1 ** state["count"])
        denom = torch._foreach_div(nu, 1 - self.b2 ** state["count"])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(out, denom)
        torch._foreach_mul_(out, -self.lr)
        return out


class OptaxOptimizer:
    """``optax.chain(*transforms)`` over a module's parameters, in place:
    ``step()`` turns every parameter's ``.grad`` into its update through the
    chain and adds it to the parameter (``optax.apply_updates``)."""

    def __init__(self, params: Iterable[torch.Tensor], *transforms):
        self.params = list(params)
        self.transforms = transforms
        self.state = [t.init(self.params) for t in transforms]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        updates = [p.grad for p in self.params]
        if any(u is None for u in updates):
            raise RuntimeError("OptaxOptimizer.step: a parameter has no gradient")
        for transform, state in zip(self.transforms, self.state):
            updates = transform.update(updates, state)
        torch._foreach_add_(self.params, updates)
