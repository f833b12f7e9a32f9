"""Cross-process data serving: numpy batches over sockets and processes.

The port's copy of ``attention_lvcsr_tpu/data/server.py`` (the Fuel roles
of ``fuel/server.py``, ``ServerDataStream`` and the ``MultiProcessing``
prefetch, on the standard library): a length-prefixed npz-over-TCP
protocol, a push server that runs the data pipeline in its own process,
and a process-based prefetcher for CPU-heavy pipelines that would fight
the training loop for the GIL.

Workers are spawned, not forked: the parent runs threads (CUDA's among
them), and forking a threaded process can deadlock the child.  The
stream factory crosses into the child pickled: with ``cloudpickle`` where
it is installed (closures and lambdas then cross too), else with
``pickle``, which carries a module-level function, a
``functools.partial`` of one, or an instance of a module-level class.
"""
from __future__ import annotations

import io
import multiprocessing as mp
import pickle
import queue as queue_mod
import socket
import struct
from typing import Callable, Dict, Iterator, Optional

import numpy as np

_MAGIC = b"LVSR"


def send_batch(sock: socket.socket, batch: Dict[str, np.ndarray]):
    """Send one batch dict (arrays and simple metadata)."""
    buf = io.BytesIO()
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    other = {k: v for k, v in batch.items()
             if not isinstance(v, np.ndarray)}
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    meta = pickle.dumps(other, protocol=4)
    sock.sendall(_MAGIC + struct.pack("<QQ", len(payload), len(meta))
                 + payload + meta)


def _recv_exact(sock, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("data server closed the connection")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_batch(sock: socket.socket) -> Optional[Dict[str, np.ndarray]]:
    """The next batch from ``sock``, or None at the end of the stream."""
    header = _recv_exact(sock, len(_MAGIC) + 16)
    if header[:4] != _MAGIC:
        raise ValueError("bad protocol magic")
    n_payload, n_meta = struct.unpack("<QQ", header[4:])
    if n_payload == 0 and n_meta == 0:
        return None  # end of epoch stream
    payload = _recv_exact(sock, n_payload)
    meta = pickle.loads(_recv_exact(sock, n_meta))
    with np.load(io.BytesIO(payload), allow_pickle=False) as npz:
        batch = {k: npz[k] for k in npz.files}
    batch.update(meta)
    return batch


def _pickler():
    """``cloudpickle`` where it is installed, else ``pickle``."""
    try:
        import cloudpickle
        return cloudpickle
    except ImportError:
        return pickle


def _dumps_factory(stream_factory) -> bytes:
    pickler = _pickler()
    try:
        return pickler.dumps(stream_factory)
    except Exception as exc:
        if pickler is pickle:
            raise TypeError(
                f"the stream factory cannot be pickled ({exc}); without "
                f"the cloudpickle package only a module-level function, "
                f"a functools.partial of one or an instance of a "
                f"module-level class crosses into the worker") from exc
        raise


def _loads_factory(blob: bytes):
    return _pickler().loads(blob)


def _serve_child(factory_blob: bytes, host: str, requested_port: int,
                 epochs: Optional[int], port_pipe):
    """Spawn target: bind, report the port, serve batches."""
    stream_factory = _loads_factory(factory_blob)
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, requested_port))
    listener.listen(1)
    port_pipe.send(listener.getsockname()[1])
    port_pipe.close()
    served = 0
    try:
        while epochs is None or served < epochs:
            conn, _ = listener.accept()
            try:
                for batch in stream_factory():
                    send_batch(conn, batch)
                conn.sendall(_MAGIC + struct.pack("<QQ", 0, 0))
                served += 1
            except (BrokenPipeError, ConnectionError):
                pass
            finally:
                conn.close()
    finally:
        listener.close()


def start_server(stream_factory: Callable[[], Iterator], port: int = 0,
                 host: str = "127.0.0.1", epochs: Optional[int] = None):
    """Serve batches to one consumer; returns (process, port).

    The pipeline runs inside a separate spawned process; each connected
    client receives batches until the stream ends, then an empty end
    marker; with ``epochs=None`` the stream restarts per connection
    indefinitely.  The child owns the listening socket (spawned children
    inherit no file descriptors) and reports the bound port back over a
    pipe."""
    ctx = mp.get_context("spawn")
    recv_end, send_end = ctx.Pipe(duplex=False)
    proc = ctx.Process(
        target=_serve_child,
        args=(_dumps_factory(stream_factory), host, port, epochs,
              send_end),
        daemon=True)
    proc.start()
    send_end.close()  # the parent's copy
    if not recv_end.poll(60):
        proc.terminate()
        raise RuntimeError("data server child did not report its port")
    try:
        actual_port = recv_end.recv()
    except EOFError:
        # poll() also returns True at the pipe's end: the child died
        # before reporting (say, the stream factory failed to unpickle in
        # the fresh interpreter)
        proc.join(5)
        raise RuntimeError(
            f"data server child exited before reporting its port "
            f"(exitcode={proc.exitcode}); check that the stream "
            f"factory's closure imports cleanly in a spawned child")
    recv_end.close()
    return proc, actual_port


class ServerDataStream:
    """Pull batches from a data server (the Fuel ServerDataStream role)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5557):
        self.host = host
        self.port = port

    def __iter__(self):
        sock = socket.create_connection((self.host, self.port))
        try:
            while True:
                batch = recv_batch(sock)
                if batch is None:
                    return
                yield batch
        finally:
            sock.close()


_MPS_DONE = "__done__"
_MPS_ERROR = "__error__"


def _prefetch_child(factory_blob: bytes, queue):
    """Spawn target for MultiProcessStream."""
    factory = _loads_factory(factory_blob)
    try:
        for batch in factory():
            queue.put(batch)
        queue.put(_MPS_DONE)
    except Exception as exc:  # pragma: no cover
        queue.put((_MPS_ERROR, repr(exc)))


class MultiProcessStream:
    """Process-based prefetch of a stream factory (the Fuel
    MultiProcessing role): the pipeline runs in a spawned process, at most
    ``depth`` batches ahead, which suits CPU-bound pipelines; the thread
    prefetcher is :class:`attention_lvcsr_torch.data.pipeline.Prefetcher`.
    The worker stops when the iteration ends or is abandoned; a worker
    that dies before the end of its stream raises ``RuntimeError`` here
    instead of leaving the reader waiting."""
    _DONE = _MPS_DONE
    _ERROR = _MPS_ERROR

    def __init__(self, stream_factory: Callable[[], Iterator], depth=4):
        self.stream_factory = stream_factory
        self.depth = depth

    def __iter__(self):
        ctx = mp.get_context("spawn")
        queue = ctx.Queue(maxsize=self.depth)
        proc = ctx.Process(
            target=_prefetch_child,
            args=(_dumps_factory(self.stream_factory), queue),
            daemon=True)
        proc.start()
        try:
            while True:
                try:
                    item = queue.get(timeout=1.0)
                except queue_mod.Empty:
                    if proc.is_alive():
                        continue
                    raise RuntimeError(
                        f"data worker exited (exitcode={proc.exitcode}) "
                        f"before the end of its stream")
                if isinstance(item, str) and item == self._DONE:
                    return
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] == self._ERROR:
                    raise RuntimeError(f"data worker failed: {item[1]}")
                yield item
        finally:
            proc.terminate()
            proc.join()
