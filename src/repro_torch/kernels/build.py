"""Build and load the port's hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` exposes a plain C interface.
It is compiled at first use with ``nvcc`` for ``sm_90a`` into a shared
library under ``<repo>/build/kernels/`` and loaded with ``ctypes`` (no
PyTorch headers, so no minutes-long extension build). A source may be
compiled as several parts — one ``nvcc -c`` each, all started together,
then linked — so its template instances build in parallel, and
`build_many` starts the parts of several sources together. The library
name carries a hash of the source, flags and parts, so an edited source
is rebuilt and a stale library is never loaded. Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v")


class BuiltLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float        # wall time of this build; 0.0 when reused
    ptxas: List[str]      # ``-Xptxas -v`` lines of the build


_LOADED: Dict[str, BuiltLibrary] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _ptxas_lines(log: str) -> List[str]:
    return [ln.strip() for ln in log.splitlines()
            if re.search(r"ptxas info|bytes stack frame|spill", ln)]


def _compile(src: Path, parts: Sequence[Sequence[str]], out: Path,
             workdir: Path) -> str:
    """Compile every part at once, link them into ``out``; returns the
    compilers' output. Raises with that output if any step fails."""
    nvcc = nvcc_path()
    procs, objs = [], []
    for i, defines in enumerate(parts):
        obj = workdir / f"part{i}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, *defines, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], False
    for proc in procs:
        logs.append(proc.communicate()[0])
        failed |= proc.returncode != 0
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(out),
                           *map(str, objs)], capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link {src}:\n{log}")
    return log


def build(name: str, parts: Sequence[Sequence[str]] = ((),)) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` (once per process and per content hash)
    as ``parts`` (each a list of extra ``nvcc`` defines) and load it."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    key = src.read_bytes() + repr((COMPILE_FLAGS, parts)).encode()
    digest = hashlib.sha1(key).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    log_path = out.with_suffix(".log")
    seconds, log = 0.0, ""
    if not out.exists():
        # Build in a private directory and rename: concurrent processes
        # never load a half-written library.
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            t0 = time.perf_counter()
            tmp_out = Path(tmp) / out.name
            log = _compile(src, parts, tmp_out, Path(tmp))
            seconds = time.perf_counter() - t0
            log_path.write_text(log)
            os.replace(tmp_out, out)
    elif log_path.exists():
        log = log_path.read_text()
    built = BuiltLibrary(ctypes.CDLL(str(out)), out, seconds,
                         _ptxas_lines(log))
    _LOADED[name] = built
    return built


def build_many(specs: Sequence[tuple]) -> Dict[str, BuiltLibrary]:
    """`build` several sources at once: ``specs`` is a sequence of
    ``(name, parts)``; every part of every source compiles at the same
    time (one thread waits on each source's ``nvcc`` processes)."""
    with ThreadPoolExecutor(max_workers=max(1, len(specs))) as pool:
        futures = {name: pool.submit(build, name, parts)
                   for name, parts in specs}
        return {name: f.result() for name, f in futures.items()}
