"""Builds the native ipxlu shared library with g++ at first use.

The library goes to build/native/<key>/libipxlu.so in the checkout (listed
in .gitignore). The key hashes the source, the compiler flags and the host
CPU as `-march=native` resolves it, so a library built from other source or
for another CPU is never loaded: a checkout copied to another machine
builds its own.

    python ipx_tpu/native/build.py [--force]   # prints the library path
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "ipxlu.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


def cpu_identity() -> str:
    """What `-march=native` selects on this host: g++'s resolved target
    options (architecture, tuning and every instruction-set switch)."""
    out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                         check=True, capture_output=True, text=True).stdout
    return " ".join(out.split())


def build_key(source: bytes, flags, cpu: str) -> str:
    """Hash of what the library is built from and for."""
    h = hashlib.sha256()
    for part in (source, " ".join(flags).encode(), cpu.encode()):
        h.update(hashlib.sha256(part).digest())
    return h.hexdigest()[:16]


def library_path() -> str:
    """Where this host's library for the current source lives."""
    with open(SRC, "rb") as f:
        key = build_key(f.read(), FLAGS, cpu_identity())
    return os.path.join(BUILD_DIR, key, "libipxlu.so")


def build(force: bool = False) -> str:
    """Compiles libipxlu.so if needed; returns its path or raises."""
    try:
        lib = library_path()
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found; native LU unavailable") from e
    if os.path.exists(lib) and not force:
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    # concurrent processes (test workers) each write their own file, then
    # rename it into place atomically
    tmp = f"{lib}.{os.getpid()}.tmp"
    base = ["g++", *FLAGS, "-o", tmp, SRC]
    try:
        try:
            subprocess.run(base[:1] + ["-fopenmp"] + base[1:], check=True,
                           capture_output=True, text=True)
        except subprocess.CalledProcessError:
            # toolchains without libgomp: serial build
            subprocess.run(base, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"ipxlu native build failed:\n{e.stderr}") from e
    os.replace(tmp, lib)
    return lib


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
