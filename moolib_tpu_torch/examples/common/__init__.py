"""Shared example plumbing: the port of the JAX package's
``examples/common`` flag parsing.  The cohort stats accumulator, the
per-actor-batch state and the TSV logger come with the RL slice."""

from __future__ import annotations

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
