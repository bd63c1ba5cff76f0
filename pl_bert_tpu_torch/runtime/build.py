"""Build the port's CUDA kernels: ``python -m pl_bert_tpu_torch.runtime.build``.

The counterpart of ``pl_bert_tpu/runtime/build.py``. Every
``pl_bert_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded
with ``ctypes``. Nothing includes PyTorch's headers, so a build takes
seconds, not minutes.

Libraries land in ``pl_bert_tpu_torch/_build/`` (git-ignored), named by
a hash of the sources and flags: an edit to a ``.cu``/``.cuh`` file or
a flag change builds a fresh library, and a stale one is never loaded.
The first call of a kernel wrapper builds its library; a failed build
raises :class:`BuildError` with the compiler's output. ``ptxas`` reports
each kernel's registers, shared memory and spills into a ``.log`` beside
the library (:func:`ptxas_report`).

Triton kernels compile on their first launch; their cache is pointed at
the same directory (``_build/triton``) unless ``TRITON_CACHE_DIR`` is set.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class LaunchCounter:
    """Kernel launches made by one wrapper: the wrapper adds one where it
    launches its kernel and nowhere else, so a run can show that its
    main path went through the kernel."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or the
    toolkit's standard prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources(name: str) -> list[Path]:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise BuildError(f"no CUDA source {src}")
    return [src, *sorted(CSRC_DIR.glob("*.cuh"))]


def library_path(name: str, extra_flags: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256()
    for path in _sources(name):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + extra_flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, extra_flags: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of these exact
    sources and flags exists. Returns the library's path."""
    out = library_path(name, extra_flags)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile under a private name and rename into place, so neither an
    # interrupted nvcc nor two processes building at once can leave a
    # truncated library at the final path
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    cmd = [nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(_sources(name)[0])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        text = (proc.stdout + proc.stderr).strip()
        if proc.returncode:
            raise BuildError(f"{' '.join(cmd)} failed:\n{text}")
        out.with_suffix(".log").write_text(text + "\n")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def ptxas_report(name: str) -> str:
    """What ``ptxas -v`` said of each kernel of ``csrc/<name>.cu``'s
    current library (built if it is not)."""
    return build(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, built at first use and
    loaded once per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise unless a C entry point returned 0 (``cudaSuccess``); the
    entry points return ``cudaGetLastError()`` right after launching,
    or a negative code for arguments they refuse."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def import_triton() -> None:
    """Import ``triton``, only where a Triton kernel is launched (the CPU
    tests import every module and have no Triton), keeping its compile
    cache inside the package's build directory unless
    ``TRITON_CACHE_DIR`` says otherwise."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton  # noqa: F401


def all_sources() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all(extra_flags: tuple[str, ...] = ()) -> dict[str, Path]:
    """Build every ``csrc/*.cu``, one ``nvcc`` a source, all started
    together; {name: library path}. The first failure raises."""
    from concurrent.futures import ThreadPoolExecutor

    names = all_sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        paths = list(pool.map(lambda n: build(n, extra_flags), names))
    return dict(zip(names, paths))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="build the port's CUDA kernels")
    parser.add_argument(
        "--ptxas_verbose", action="store_true",
        help="print each kernel's registers, shared memory and spills",
    )
    args = parser.parse_args(argv)
    for name, path in build_all().items():
        print(f"built {path}", flush=True)
        if args.ptxas_verbose:
            print(ptxas_report(name), flush=True)


if __name__ == "__main__":
    main()
