"""PyTorch port: resilience/quiet_http.py QuietServer, the api_server's HTTP server.

The copy's routine-disconnect set equals the JAX package's; a routine disconnect is
silent and any other error still prints its traceback; and a port server whose client
drops an SSE stream mid-way answers it with no traceback on stderr."""

import json
import socket
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler

import pytest

from distributed_llama_tpu.resilience import quiet_http as jquiet
from distributed_llama_tpu_torch.apps import api_server
from distributed_llama_tpu_torch.resilience import quiet_http
from distributed_llama_tpu_torch.resilience.quiet_http import QuietServer

from test_torch_paged_cache import files  # noqa: F401  (the tiny .m/.t fixture)


def test_routine_disconnects_match_jax():
    assert quiet_http._ROUTINE_DISCONNECTS == jquiet._ROUTINE_DISCONNECTS


@pytest.mark.parametrize("exc,quiet", [(BrokenPipeError, True), (ConnectionResetError, True),
                                       (ConnectionAbortedError, True), (TimeoutError, True),
                                       (ValueError, False)])
def test_handle_error_is_quiet_only_for_disconnects(exc, quiet, capfd):
    srv = QuietServer(("127.0.0.1", 0), BaseHTTPRequestHandler)
    try:
        try:
            raise exc("peer")
        except exc:
            srv.handle_error(None, ("127.0.0.1", 1))
    finally:
        srv.server_close()
    err = capfd.readouterr().err
    assert ("Traceback" in err) is not quiet


def test_dropped_sse_stream_leaves_no_traceback(files, capfd):  # noqa: F811
    """The client resets its socket after the first SSE event; the server's next write
    fails with a routine disconnect, which reaches handle_error and prints nothing."""
    mpath, tpath = files
    srv = api_server.build_server(api_server.build_parser().parse_args(
        ["--model", mpath, "--tokenizer", tpath, "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0", "--chat-template", "llama2", "--no-prefix-cache"]))
    assert isinstance(srv, QuietServer)
    seen = []
    handle = srv.handle_error

    def recording(request, client_address):
        import sys

        seen.append(type(sys.exc_info()[1]))
        handle(request, client_address)
    srv.handle_error = recording
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        body = json.dumps({"messages": [{"role": "user", "content": "ab cd"}],
                           "max_tokens": 200, "temperature": 0, "stream": True}).encode()
        sock = socket.create_connection(("127.0.0.1", srv.server_address[1]), timeout=60)
        sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        got = b""
        while b"data: " not in got:
            got += sock.recv(4096)
        # an abortive close (RST): the server's next write fails at once
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        sock.close()
        t0 = time.time()
        while not seen and time.time() - t0 < 60:
            time.sleep(0.05)
    finally:
        srv.shutdown()
        srv.server_close()
    assert seen and issubclass(seen[0], quiet_http._ROUTINE_DISCONNECTS), seen
    assert "Traceback" not in capfd.readouterr().err
