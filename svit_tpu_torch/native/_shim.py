"""Build and load one of the port's native libraries (``Makefile``).

Each library is built with ``make`` at first use into
``svit_tpu_torch/_build/native/`` (git-ignored), one process at a time: a
file lock, since loader processes would race to build the same file and
one could load it half written.  A build that fails is tried once per
process; its stderr is kept, so a caller that needs the library can say
why it is missing (``Shim.require``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Callable, Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(os.path.dirname(_DIR), "_build", "native")


class Shim:
    """The library ``name`` (a ``Makefile`` target under ``OUT``);
    ``bind(lib)`` declares its functions' ctypes signatures."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.path = os.path.join(OUT, name)
        self.bind = bind
        self.error: Optional[str] = None
        self._lib = None
        self._tried = False
        self._lock = threading.Lock()

    def _build(self) -> bool:
        import fcntl

        try:
            os.makedirs(OUT, exist_ok=True)
            with open(os.path.join(OUT, ".build.lock"), "w") as lockf:
                fcntl.flock(lockf, fcntl.LOCK_EX)
                if os.path.isfile(self.path):
                    return True
                subprocess.run(["make", "-s", "-C", _DIR, f"OUT={OUT}",
                                self.path], check=True, capture_output=True,
                               text=True, timeout=120)
                return os.path.isfile(self.path)
        except subprocess.CalledProcessError as e:
            self.error = (e.stderr or e.stdout or str(e)).strip()
        except Exception as e:  # no make, no compiler, a timeout
            self.error = f"{type(e).__name__}: {e}"
        return False

    def load(self):
        """The bound library, or None when it cannot be built or loaded."""
        with self._lock:
            if self._lib is not None or self._tried:
                return self._lib
            self._tried = True
            if not os.path.isfile(self.path) and not self._build():
                return None
            try:
                lib = ctypes.CDLL(self.path)
            except OSError as e:
                self.error = str(e)
                return None
            self.bind(lib)
            self._lib = lib
            return lib

    def require(self):
        """The bound library; raises with the build's error when it is
        missing."""
        lib = self.load()
        if lib is None:
            raise RuntimeError(
                f"{os.path.basename(self.path)} could not be built or "
                f"loaded: {self.error}")
        return lib
