"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` compiles for ``sm_90a`` to an object file -- one
``nvcc`` per source, all started together -- and the objects link into
``build/repro_torch/libkernels.so`` at the root of the checkout.  A hash
of the sources, the headers they share (``csrc/*.cuh``) and the flags is
stored beside the library: an unchanged source tree loads the library
already built, a changed one rebuilds.

The sources expose a plain C interface (pointers, ints, the stream), so
no PyTorch header is compiled and a build takes seconds.

    python -m repro_torch.kernels._build --ptxas   # each kernel's registers,
                                                   # shared memory, spills,
                                                   # and its tensor-core and
                                                   # TMA instructions
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libkernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: SASS instructions counted in each kernel: wgmma, TMA tensor loads, and
#: the warp-level mma.sync
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return h.hexdigest()


def _compile_all(out_dir: Path, extra: tuple[str, ...] = ()) -> tuple[
        list[Path], list[tuple[Path, str]], list[str]]:
    """One ``nvcc -c`` per source, all started together.  Returns the
    objects, each source's compiler output, and the failures."""
    nvcc = nvcc_path()
    objs, procs = [], []
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    outputs, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        outputs.append((src, out))
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    return objs, outputs, failed


def ptxas_report(build_dir: Path = BUILD_DIR) -> str:
    """What ``ptxas -v`` says of every kernel (registers, shared memory,
    spill stores and loads), each source compiled again beside the build."""
    out_dir = build_dir / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    objs, outputs, failed = _compile_all(out_dir, ("-Xptxas", "-v"))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "\n".join(f"== {src.name}\n{out}{sass_counts(obj)}"
                     for obj, (src, out) in zip(objs, outputs))


def sass_counts(obj: Path) -> str:
    """Each kernel's count of the ``SASS_OPS`` instructions in an object,
    from ``cuobjdump -sass``, one line a kernel."""
    tool = shutil.which("cuobjdump") or str(Path(nvcc_path()).with_name(
        "cuobjdump"))
    if not Path(tool).exists():
        return "cuobjdump not found: no SASS counts\n"
    sass = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                          text=True, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    kernel = None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            kernel = head.group(1)
            counts[kernel] = dict.fromkeys(SASS_OPS, 0)
        elif kernel is not None:
            for op in SASS_OPS:
                counts[kernel][op] += bool(re.search(rf"\b{op}\b", line))
    return "".join(f"sass {name}: " + ", ".join(
        f"{op} {n}" for op, n in c.items()) + "\n"
        for name, c in counts.items())


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile every source in parallel and link the shared library.
    Raises ``RuntimeError`` with the compiler's output when any step
    fails.  Returns the library's path."""
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / LIB_NAME
    stamp = build_dir / (LIB_NAME + ".sha256")
    digest = source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    objs, _, failed = _compile_all(build_dir)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = build_dir / (LIB_NAME + ".tmp")
    link = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-shared", "-o",
                           str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def function(name: str, n_ptrs: int, n_ints: int):
    """C entry point ``name(ptr * n_ptrs, int * n_ints, stream) -> int``.

    Every pointer and the stream are ``c_void_p`` (a default ctypes int
    would cut a 64-bit pointer); the int result is ``cudaGetLastError()``
    after the launch."""
    fn = getattr(load(), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


if __name__ == "__main__":
    import sys
    if sys.argv[1:] != ["--ptxas"]:
        sys.exit("usage: python -m repro_torch.kernels._build --ptxas")
    print(ptxas_report())
