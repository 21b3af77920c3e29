"""The port's wire plane: codec round trips, port-to-port Rpc, and a mixed
call between a port peer and a JAX-package peer over the shared wire."""

import asyncio
import threading

import numpy as np
import pytest
import torch

from moolib_tpu_torch.rpc import Rpc, RpcError, serialization
from moolib_tpu_torch.utils import nest

torch.set_num_threads(1)


def _payload():
    return {
        "f32": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "i64": torch.tensor([1, -2, 3]),
        "bf16": torch.tensor([[1.5, -2.25], [3.0, 0.125]], dtype=torch.bfloat16),
        "scalar": torch.tensor(7.5),
        "np": np.arange(4, dtype=np.int32),
        "strided": torch.arange(12, dtype=torch.float32).reshape(3, 4).t(),
        "info": ["tag", 3, None, (1.5, b"x")],
    }


def _check_roundtrip(out):
    # Tensors come back as numpy, bf16 as a torch.bfloat16 tensor.
    np.testing.assert_array_equal(out["f32"], np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_array_equal(out["i64"], np.array([1, -2, 3]))
    assert isinstance(out["bf16"], torch.Tensor) and out["bf16"].dtype == torch.bfloat16
    assert torch.equal(out["bf16"], _payload()["bf16"])
    assert out["scalar"].shape == () and float(out["scalar"]) == 7.5
    np.testing.assert_array_equal(out["np"], np.arange(4, dtype=np.int32))
    np.testing.assert_array_equal(
        out["strided"], np.arange(12, dtype=np.float32).reshape(3, 4).T)
    assert out["info"] == ["tag", 3, None, (1.5, b"x")]


@pytest.mark.parametrize("portable", [False, True])
def test_codec_roundtrip_torch_and_numpy_leaves(portable):
    if portable:
        blob = serialization.pack_bytes(serialization._py_serialize(_payload()))
    else:
        assert serialization.native_available()
        blob = serialization.dumps(_payload())
    _check_roundtrip(serialization.loads(blob))


def test_bf16_is_raw_two_byte_payload_under_its_tag():
    t = torch.tensor([1.0, -0.5, 3.25], dtype=torch.bfloat16)
    sp = serialization.serialize({"w": t})
    assert isinstance(sp, serialization.SerializedPayload)  # left the native codec
    (ref,) = sp.arrays
    assert ref.dtype == "bfloat16" and ref.kind == "np" and ref.shape == (3,)
    assert bytes(ref.data) == t.view(torch.int16).numpy().tobytes()


def test_nest_stack_and_unstack():
    a = {"x": torch.ones(2), "y": np.zeros(3), "s": "a"}
    b = {"x": torch.zeros(2), "y": np.ones(3), "s": "b"}
    st = nest.stack([a, b])
    assert isinstance(st["x"], torch.Tensor) and st["x"].shape == (2, 2)
    assert isinstance(st["y"], np.ndarray) and st["y"].shape == (2, 3)
    assert list(st["s"]) == ["a", "b"]
    back = nest.unstack(st)
    assert torch.equal(back[1]["x"], b["x"]) and back[0]["s"] == "a"
    np.testing.assert_array_equal(back[1]["y"], b["y"])
    assert nest.cat([{"x": torch.ones(2)}, {"x": torch.zeros(1)}])["x"].shape == (3,)


@pytest.fixture(params=["native", "asyncio"])
def transport(request, monkeypatch):
    if request.param == "asyncio":
        monkeypatch.setenv("MOOLIB_TPU_NATIVE_TRANSPORT", "0")
    return request.param


def test_define_sync_async_between_port_peers(free_port, transport):
    server, client = Rpc(), Rpc()
    try:
        server.set_name("srv")
        server.listen(f"127.0.0.1:{free_port}")
        client.set_name("cli")
        client.set_timeout(30)
        client.connect(f"127.0.0.1:{free_port}")
        server.define("echo", lambda x: x)
        server.define("add", lambda a, b=0: a + b)
        _check_roundtrip(client.sync("srv", "echo", _payload()))
        fut = client.async_("srv", "add", torch.tensor([1.0, 2.0]), b=torch.tensor([3.0, 4.0]))
        np.testing.assert_array_equal(fut.result(30), np.array([4.0, 6.0], np.float32))

        def boom():
            raise ValueError("no such thing")

        server.define("boom", boom)
        with pytest.raises(RpcError, match="no such thing"):
            client.sync("srv", "boom")
    finally:
        client.close()
        server.close()


def test_dynamic_batching_queue_between_port_peers(free_port):
    server, client = Rpc(), Rpc()
    try:
        server.set_name("srv")
        server.listen(f"127.0.0.1:{free_port}")
        client.set_name("cli")
        client.set_timeout(30)
        client.connect(f"127.0.0.1:{free_port}")
        queue = server.define_queue("double", batch_size=8, dynamic_batching=True)
        futs = [client.async_("srv", "double", torch.full((3,), float(i))) for i in range(6)]
        sizes = []

        async def loop():
            served = 0
            while served < 6:
                ret_cb, args, _ = await queue
                batch = args[0]  # a lone call arrives unstacked
                n = 1 if batch.ndim == 1 else batch.shape[0]
                sizes.append(n)
                served += n
                ret_cb(batch * 2)

        th = threading.Thread(target=lambda: asyncio.run(asyncio.wait_for(loop(), 30)))
        th.start()
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(30), np.full(3, 2.0 * i, np.float32))
        th.join(30)
        assert not th.is_alive() and sum(sizes) == 6
    finally:
        client.close()
        server.close()


def test_mixed_cohort_port_and_jax_peers(free_port):
    """A port client calls a moolib_tpu server and back: the wire is shared."""
    import jax.numpy as jnp

    import moolib_tpu

    jax_srv = moolib_tpu.Rpc()
    port = Rpc()
    try:
        jax_srv.set_name("jax_srv")
        jax_srv.listen(f"127.0.0.1:{free_port}")
        port.set_name("port_cli")
        port.set_timeout(30)
        port.connect(f"127.0.0.1:{free_port}")
        seen = {}

        def scale(x, w):
            seen["types"] = (type(x).__name__, type(w).__name__, str(w.dtype))
            return {"y": jnp.asarray(x) * 2, "w": w, "b16": jnp.ones(2, jnp.bfloat16)}

        jax_srv.define("scale", scale)
        out = port.sync("jax_srv", "scale", torch.arange(4, dtype=torch.float32),
                        torch.tensor([0.5, 1.5], dtype=torch.bfloat16))
        np.testing.assert_array_equal(out["y"], np.arange(4, dtype=np.float32) * 2)
        # The JAX peer saw an ml_dtypes bfloat16 array and echoed it through
        # its native codec as a numpy leaf, which stays numpy here; its own
        # jax bf16 array (the accelerator leaf) arrives as torch.bfloat16.
        assert seen["types"] == ("ndarray", "ndarray", "bfloat16")
        assert out["w"].dtype.name == "bfloat16"
        np.testing.assert_array_equal(out["w"].astype(np.float32), [0.5, 1.5])
        assert out["b16"].dtype == torch.bfloat16 and out["b16"].tolist() == [1.0, 1.0]

        # And the other way: the JAX peer calls a function the port defines.
        port.define("neg", lambda x: -torch.as_tensor(x))
        back = jax_srv.sync("port_cli", "neg", jnp.arange(3, dtype=jnp.float32))
        np.testing.assert_array_equal(np.asarray(back), -np.arange(3, dtype=np.float32))
    finally:
        port.close()
        jax_srv.close()
