"""Build the native host runtime (g++ → shared library).

Compiles :mod:`ibu_jax.native.ibu_native` on first use into ``_build/``
beside the source, under a name keyed on the source's hash and the compiler
flags, so a library is reused only when it was built from this very source
with these flags. ``-march=native`` makes the library specific to the host
that built it; ``_build/`` is never committed, so every host builds its own.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "ibu_native.cpp")
BUILD_DIR = os.path.join(_DIR, "_build")
FLAGS = (
    "-O3",
    "-march=native",
    "-funroll-loops",
    "-std=c++17",
    "-shared",
    "-fPIC",
    "-pthread",
)


class NativeBuildError(RuntimeError):
    pass


def library_path() -> str:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update("\0".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libibu_native-{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> str:
    """Compile (if needed) and return the shared-library path."""
    lib = library_path()
    if not force and os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename into place: concurrent first
    # uses (test workers, cohort ranks) never load a half-written library
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = ["g++", *FLAGS, SRC, "-o", tmp]
    try:
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=120
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"failed to run g++: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"native build failed:\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


if __name__ == "__main__":
    print(build(force=True))
