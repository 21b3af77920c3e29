"""Hypothesis sweeps over the port's wire codecs.

The port of ``tests/test_ring_codec_props.py`` (bounded, deterministic
per-hop compression on the edge shapes churn produces), and the codecs
held bit for bit against the JAX package's on the same arrays:

- the bf16 wire encode (``torch.bfloat16``, no ml_dtypes needed) gives the
  bits ml_dtypes gives, for every finite float32 including subnormals, and
  for ±inf;
- the q8 wire encode gives the same int8 payload and scale;
- ``buckets.ef_quantize_flat`` leaves the same grid values and residual.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from moolib_tpu import buckets as jax_buckets  # noqa: E402
from moolib_tpu.group import _ring_codec as jax_ring_codec  # noqa: E402
from moolib_tpu_torch import buckets  # noqa: E402
from moolib_tpu_torch.group import _ring_codec  # noqa: E402

torch.set_num_threads(1)

_chunks = st.builds(
    lambda sh, seed, scale: (
        np.random.default_rng(seed).normal(size=sh).astype(np.float32) * scale
    ),
    st.lists(st.integers(0, 5), min_size=1, max_size=2).map(tuple),
    st.integers(0, 2**31),
    st.sampled_from([0.0, 1e-6, 1.0, 1e6]),
)

# Every finite float32 (subnormals included) and both infinities, as raw
# arrays: hypothesis shrinks toward the rounding edge cases on its own.
_f32 = st.floats(width=32, allow_nan=False, allow_infinity=True, allow_subnormal=True)
_f32_arrays = st.lists(_f32, min_size=0, max_size=64).map(
    lambda xs: np.asarray(xs, np.float32))
# Values on both sides of a bf16 rounding tie: the low 16 bits at and
# around 0x8000, with random sign, exponent (subnormals too) and mantissa.
_ties = st.lists(
    st.tuples(st.integers(0, 0x7F7F), st.integers(0x7FFE, 0x8002)),
    min_size=1, max_size=64,
).map(lambda ps: np.asarray([(hi << 16) | lo for hi, lo in ps], np.uint32).view(np.float32)
      * np.float32(1.0))


@settings(max_examples=120, deadline=None)
@given(_chunks)
def test_q8_roundtrip_bounded_and_deterministic(a):
    enc, dec, cast = _ring_codec("q8")
    w1, w2 = enc(a), enc(a)
    # Deterministic: the all-gather forwards wire bytes unchanged, so every
    # rank must decode identical values — encoding cannot be stochastic.
    np.testing.assert_array_equal(w1["q8"], w2["q8"])
    assert w1["s"] == w2["s"]
    out = dec(w1)
    assert out.shape == a.shape and out.dtype == np.float32
    amax = float(np.max(np.abs(a))) if a.size else 0.0
    # Symmetric per-chunk quantization: error bounded by half a grid step.
    np.testing.assert_allclose(out, a, atol=amax / 127.0 * 0.5 + 1e-12)


@settings(max_examples=120, deadline=None)
@given(_chunks)
def test_bf16_roundtrip_bounded(a):
    enc, dec, cast = _ring_codec("bfloat16")
    wire = enc(a)
    assert isinstance(wire, torch.Tensor) and wire.dtype == torch.bfloat16
    out = dec(wire)
    assert out.shape == a.shape and out.dtype == np.float32
    # bf16 keeps ~8 mantissa bits: relative error under 1%.
    np.testing.assert_allclose(out, a, rtol=1e-2, atol=1e-30)


@settings(max_examples=60, deadline=None)
@given(_chunks)
def test_none_codec_is_identity(a):
    enc, dec, cast = _ring_codec(None)
    assert enc(a) is a and dec(a) is a and cast(a) is a


def _bits_equal_ml_dtypes(a):
    enc, dec, _ = _ring_codec("bfloat16")
    got = enc(a).view(torch.int16).numpy()
    want = a.astype(ml_dtypes.bfloat16).view(np.int16)
    np.testing.assert_array_equal(got, want)
    # The JAX package's own encode (ml_dtypes) decodes to the same floats
    # through the port's decode, so either side's wire reads the same.
    jenc, jdec, _ = jax_ring_codec("bfloat16")
    np.testing.assert_array_equal(dec(jenc(a)), jdec(jenc(a)))
    np.testing.assert_array_equal(dec(enc(a)), jdec(jenc(a)))


@settings(max_examples=300, deadline=None)
@given(_f32_arrays)
def test_bf16_encode_bits_equal_ml_dtypes(a):
    _bits_equal_ml_dtypes(a)


@settings(max_examples=200, deadline=None)
@given(_ties)
def test_bf16_encode_bits_equal_ml_dtypes_at_ties(a):
    _bits_equal_ml_dtypes(a)


def test_bf16_encode_edges_equal_ml_dtypes():
    """The named edges, whatever hypothesis draws: the smallest and largest
    subnormals, the largest finite float32 (rounds to inf), ±inf, ±0 and
    exact ties to even."""
    info = np.finfo(np.float32)
    a = np.array([info.smallest_subnormal, -info.smallest_subnormal, info.tiny * 0.999,
                  info.tiny, info.max, -info.max, np.inf, -np.inf, 0.0, -0.0,
                  1.00390625, 1.01171875, 3.0e38, 1e-40, -2.5e-39], np.float32)
    _bits_equal_ml_dtypes(a)


@settings(max_examples=150, deadline=None)
@given(_chunks)
def test_q8_encode_equals_jax(a):
    enc, _, cast = _ring_codec("q8")
    jenc, _, jcast = jax_ring_codec("q8")
    got, want = enc(cast(a)), jenc(jcast(a))
    np.testing.assert_array_equal(got["q8"], want["q8"])
    assert got["q8"].dtype == want["q8"].dtype == np.int8
    assert got["s"] == want["s"]


@settings(max_examples=80, deadline=None)
@given(_chunks, st.integers(1, 7), st.booleans())
def test_ef_quantize_flat_equals_jax(a, nb, with_residual):
    flat = a.reshape(-1).copy()
    n = flat.size
    edges = sorted({0, n, *(min(n, k * max(1, n // nb)) for k in range(1, nb))})
    bounds = list(zip(edges[:-1], edges[1:]))
    rng = np.random.default_rng(n)
    res0 = rng.normal(size=n).astype(np.float32) * 1e-3 if with_residual else None
    f_port, f_jax = flat.copy(), flat.copy()
    r_port = buckets.ef_quantize_flat(f_port, None if res0 is None else res0.copy(), bounds)
    r_jax = jax_buckets.ef_quantize_flat(f_jax, None if res0 is None else res0.copy(), bounds)
    np.testing.assert_array_equal(f_port, f_jax)
    np.testing.assert_array_equal(r_port, r_jax)
    # The grid values reproduce the same ints through either q8 encode.
    enc, _, _ = _ring_codec("q8")
    jenc, _, _ = jax_ring_codec("q8")
    for s, e in bounds:
        np.testing.assert_array_equal(enc(f_port[s:e])["q8"], jenc(f_jax[s:e])["q8"])
