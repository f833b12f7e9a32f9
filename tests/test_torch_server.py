"""The port's data server and process prefetch against the JAX package's
(CPU).

``send_batch`` puts the JAX package's bytes on the wire and each
package's ``recv_batch`` reads the other's; ``MultiProcessStream`` runs a
module-level factory in a spawned worker with and without
``cloudpickle`` (a closure needs it, and the error names it); a worker
that dies before reporting its port is diagnosed; the TCP server serves
its batches to ``ServerDataStream``."""
import socket
import sys
import time

import numpy as np
import pytest

from attention_lvcsr_tpu.data import server as jax_server
from attention_lvcsr_torch.data import server


def _batches():
    for i in range(5):
        yield {"x": np.full((2, 3), i, "float32"),
               "y": np.arange(4, dtype=np.int64) * i, "idx": i,
               "uttid": f"utt{i}"}


def _wire(send, batch):
    """The bytes ``send`` puts on a socket for ``batch``."""
    a, b = socket.socketpair()
    try:
        send(a, batch)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)
    finally:
        a.close()
        b.close()


def test_wire_bytes_are_the_jax_packages(monkeypatch):
    # the npz's zip entries carry the time of writing: hold it still
    monkeypatch.setattr(time, "time", lambda: 1.0e9)
    batch = next(_batches())
    ours = _wire(server.send_batch, batch)
    assert ours == _wire(jax_server.send_batch, batch)
    assert ours[:4] == b"LVSR"


@pytest.mark.parametrize("sender,receiver", [
    (server.send_batch, jax_server.recv_batch),
    (jax_server.send_batch, server.recv_batch),
    (server.send_batch, server.recv_batch)], ids=["to_jax", "from_jax",
                                                   "port"])
def test_batches_cross_between_the_packages(sender, receiver):
    a, b = socket.socketpair()
    try:
        for batch in _batches():
            sender(a, batch)
        a.sendall(b"LVSR" + bytes(16))            # the end marker
        got = []
        while (item := receiver(b)) is not None:
            got.append(item)
    finally:
        a.close()
        b.close()
    assert len(got) == 5
    for want, have in zip(_batches(), got):
        assert set(have) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(have[k], v)
            assert type(have[k]) is type(v)


@pytest.mark.parametrize("cloudpickle", [True, False],
                         ids=["cloudpickle", "pickle"])
def test_multiprocess_stream_runs_a_module_level_factory(cloudpickle,
                                                         monkeypatch):
    if not cloudpickle:
        monkeypatch.setitem(sys.modules, "cloudpickle", None)
    else:
        pytest.importorskip("cloudpickle")
    assert (server._pickler().__name__ == "cloudpickle") == cloudpickle
    got = list(server.MultiProcessStream(_batches, depth=2))
    assert [b["idx"] for b in got] == list(range(5))
    np.testing.assert_array_equal(got[-1]["x"], np.full((2, 3), 4, "f"))


def test_a_closure_needs_cloudpickle(monkeypatch):
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    n = 3
    with pytest.raises(TypeError, match="cloudpickle"):
        list(server.MultiProcessStream(lambda: iter(range(n))))


def _boom():
    raise RuntimeError("boom at unpickle")


class ExplodesOnLoad:
    """Pickles, and raises when unpickled."""

    def __reduce__(self):
        return (_boom, ())


def test_server_child_crash_is_diagnosed():
    with pytest.raises(RuntimeError, match="exited before reporting"):
        server.start_server(ExplodesOnLoad(), epochs=1)


def test_multiprocess_worker_crash_is_diagnosed():
    with pytest.raises(RuntimeError, match="data worker exited"):
        list(server.MultiProcessStream(ExplodesOnLoad()))


def test_server_roundtrip():
    proc, port = server.start_server(_batches, epochs=1)
    try:
        got = list(server.ServerDataStream(port=port))
    finally:
        proc.terminate()
        proc.join()
    assert len(got) == 5
    np.testing.assert_array_equal(got[3]["x"], np.full((2, 3), 3, "f"))
    assert got[3]["idx"] == 3 and got[3]["uttid"] == "utt3"
