"""QuietServer: a ThreadingHTTPServer that does not stack-trace routine peer
disconnects.

The port's copy of the JAX package's resilience/quiet_http.py. A streaming server sees
dropped sockets all the time: clients abandon SSE streams, and the durable fleet router
aborts its upstream leg the moment it resumes a request elsewhere. Each one would print
a full socketserver traceback to stderr, burying real errors. Anything that is not a
routine peer-went-away still reports normally. Stdlib only.
"""

from __future__ import annotations

import sys
from http.server import ThreadingHTTPServer

__all__ = ["QuietServer"]

_ROUTINE_DISCONNECTS = (BrokenPipeError, ConnectionResetError,
                        ConnectionAbortedError, TimeoutError)


class QuietServer(ThreadingHTTPServer):
    def handle_error(self, request, client_address):
        if isinstance(sys.exc_info()[1], _ROUTINE_DISCONNECTS):
            return
        super().handle_error(request, client_address)
