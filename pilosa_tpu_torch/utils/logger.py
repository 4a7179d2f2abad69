"""Logger interface (reference: logger/logger.go:27 — Logger iface with
Printf/Debugf, NopLogger, standard + verbose impls)."""

import sys
import threading
import time


class NopLogger:
    def printf(self, fmt, *args):
        pass

    def debugf(self, fmt, *args):
        pass


class StandardLogger:
    """Timestamped printf logging to a stream; debugf only when verbose
    (reference: verboseLogger logger.go:57)."""

    def __init__(self, stream=None, verbose=False):
        self.stream = stream if stream is not None else sys.stderr
        self.verbose = verbose
        self._lock = threading.Lock()

    def _emit(self, fmt, args):
        msg = (fmt % args) if args else fmt
        stamp = time.strftime("%Y-%m-%dT%H:%M:%S")
        with self._lock:
            self.stream.write(f"{stamp} {msg}\n")
            self.stream.flush()

    def printf(self, fmt, *args):
        self._emit(fmt, args)

    def debugf(self, fmt, *args):
        if self.verbose:
            self._emit(fmt, args)


class CaptureLogger:
    """Collects log lines; for tests."""

    def __init__(self):
        self.lines = []
        self._lock = threading.Lock()

    def printf(self, fmt, *args):
        with self._lock:
            self.lines.append((fmt % args) if args else fmt)

    debugf = printf
