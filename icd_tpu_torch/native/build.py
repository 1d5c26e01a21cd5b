"""Build a native library with g++ at its first use.

Each library is compiled from the repository's sources into ``build/``
at the repository root, under a name that carries a hash of its sources
and flags, so an edited source builds anew and two checkouts never share
a stale binary. A build writes a temporary file and renames it into
place, so processes that build at once each leave a whole library.
Importing this module builds nothing.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


class NativeLibrary:
    """``lib<name>_<hash>.so`` from ``sources`` (file names in this
    directory), compiled with ``flags`` beside ``CXX_FLAGS`` and linked
    with ``libs``; ``bind(lib)`` declares the ctypes signatures once it
    is loaded. ``load()`` builds and loads it on its first call and
    raises ``OSError`` with g++'s error output when the build fails (and
    again on every later call, without rebuilding)."""

    def __init__(self, name, sources, bind, libs=(), flags=()):
        self.name = name
        self.sources = [os.path.join(_DIR, s) for s in sources]
        self.libs = tuple(libs)
        self.flags = tuple(flags)
        self._bind = bind
        self._lib = None
        self._error = None
        self._lock = threading.Lock()

    def path(self):
        digest = hashlib.sha256(
            " ".join(CXX_FLAGS + self.flags + self.libs).encode())
        for source in self.sources:
            with open(source, "rb") as f:
                digest.update(f.read())
        return os.path.join(BUILD_DIR, "lib{}_{}.so".format(
            self.name, digest.hexdigest()[:16]))

    def load(self):
        with self._lock:
            if self._lib is not None:
                return self._lib
            if self._error is not None:
                raise OSError(self._error)
            out = self.path()
            if not os.path.exists(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = "{}.{}.tmp".format(out, os.getpid())
                cxx = os.environ.get("CXX", "g++")
                cmd = [cxx, *CXX_FLAGS, *self.flags, "-o", tmp,
                       *self.sources, *self.libs]
                try:
                    proc = subprocess.run(cmd, capture_output=True,
                                          text=True)
                except OSError as e:  # no compiler at all
                    self._error = "building lib{} failed: {}".format(
                        self.name, e)
                    raise OSError(self._error) from e
                if proc.returncode != 0:
                    self._error = "building lib{} failed ({}): {}".format(
                        self.name, " ".join(cmd), proc.stderr[-4000:])
                    raise OSError(self._error)
                os.replace(tmp, out)
            lib = ctypes.CDLL(out)
            self._bind(lib)
            self._lib = lib
            return lib
