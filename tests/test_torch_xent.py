"""Parity of the port's chunked-vocab cross-entropy with the JAX package's.

Mirrors tests/test_xent.py: loss *and* gradients against the JAX
``chunked_softmax_xent`` across a chunk equal to the vocab, a dividing
chunk and a ragged tail, bf16 matmul inputs, and the LM-head wrapper on a
converted model.  Inputs come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from moolib_tpu.models import transformer as jtf
from moolib_tpu.ops import xent as jx
from moolib_tpu_torch.models import transformer as ttf
from moolib_tpu_torch.models.convert import from_flax
from moolib_tpu_torch.ops import xent as tx

torch.set_num_threads(1)


def _data(n=24, d=16, v=50, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(v,)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, size=(n,)).astype(np.int32)
    return h, w, b, labels


def _jax(h, w, b, labels, **kw):
    return jax.value_and_grad(
        lambda h_, w_, b_: jx.chunked_softmax_xent(h_, w_, b_, jnp.asarray(labels), **kw),
        argnums=(0, 1, 2),
    )(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))


def _port(h, w, b, labels, **kw):
    th, tw, tb = (torch.from_numpy(x).requires_grad_() for x in (h, w, b))
    loss = tx.chunked_softmax_xent(th, tw, tb, torch.from_numpy(labels), **kw)
    loss.backward()
    return loss.detach(), (th.grad, tw.grad, tb.grad)


@pytest.mark.parametrize("chunk", [50, 25, 16])  # = V, divides V, ragged tail
def test_loss_and_grads_match_jax(chunk):
    h, w, b, labels = _data()
    want_loss, want_grads = _jax(h, w, b, labels, chunk_size=chunk)
    loss, grads = _port(h, w, b, labels, chunk_size=chunk)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    for got, want, name in zip(grads, want_grads, ("dh", "dw", "db")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6,
                                   err_msg=name)


def test_labels_on_chunk_boundaries():
    h, w, b, _ = _data(n=8, v=64)
    labels = np.array([0, 15, 16, 17, 31, 32, 33, 63], np.int32)
    got = tx.chunked_softmax_xent(*map(torch.from_numpy, (h, w, b, labels)), chunk_size=16)
    want = jx.naive_softmax_xent(*map(jnp.asarray, (h, w, b, labels)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_naive_matches_jax_naive():
    h, w, b, labels = _data(seed=3)
    got = tx.naive_softmax_xent(*map(torch.from_numpy, (h, w, b, labels)))
    want = jx.naive_softmax_xent(*map(jnp.asarray, (h, w, b, labels)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    got_nb = tx.naive_softmax_xent(torch.from_numpy(h), torch.from_numpy(w), None,
                                   torch.from_numpy(labels))
    want_nb = jx.naive_softmax_xent(jnp.asarray(h), jnp.asarray(w), None, jnp.asarray(labels))
    np.testing.assert_allclose(float(got_nb), float(want_nb), rtol=1e-6)


def test_compute_dtype_bf16_matches_jax_loosely():
    # bf16 matmul inputs with f32 logits on both sides (the hazard: bf16
    # torch.matmul would round the logits themselves to bf16).
    h, w, b, labels = _data(seed=1)
    want_loss, want_grads = _jax(h, w, b, labels, chunk_size=16, compute_dtype=jnp.bfloat16)
    loss, grads = _port(h, w, b, labels, chunk_size=16, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    f32 = float(tx.chunked_softmax_xent(*map(torch.from_numpy, (h, w, b, labels)),
                                        chunk_size=16))
    assert abs(float(loss) - f32) > 1e-6  # the inputs really were rounded
    for got, want, name in zip(grads, want_grads, ("dh", "dw", "db")):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=2e-2,
                                   atol=2e-3, err_msg=name)


def test_chunk_logits_are_f32_from_bf16_inputs():
    h, w, _, _ = _data(seed=2)
    hb, wb = torch.from_numpy(h).bfloat16(), torch.from_numpy(w).bfloat16()
    got = tx._logits_f32(hb, wb)
    want = np.asarray(jnp.dot(jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                              preferred_element_type=jnp.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (torch.matmul(hb, wb).float() - got).abs().max() > 1e-4  # bf16 output differs


def test_lm_head_xent_matches_jax_on_a_converted_model():
    cfg = dict(vocab_size=97, d_model=32, num_heads=4, num_layers=2, max_len=64,
               attention="dense")
    jm = jtf.TransformerLM(dtype=jnp.float32, **cfg)
    toks = np.random.default_rng(1).integers(0, 97, size=(2, 12)).astype(np.int32)
    params = jm.init(jax.random.key(0), jnp.asarray(toks))
    want, want_grads = jax.value_and_grad(
        lambda p: jx.lm_head_xent(jm, p, jnp.asarray(toks), chunk_size=32))(params)
    want_grads = from_flax(jax.tree_util.tree_map(np.asarray, want_grads))
    tm = ttf.TransformerLM(dtype=torch.float32, device="cpu", **cfg)
    tm.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, params)))
    got = tx.lm_head_xent(tm, torch.from_numpy(toks), chunk_size=32)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=5e-4,
                                   atol=1e-5, err_msg=name)
