"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel package keeps its sources under ``kernels/<name>/csrc/``.
:func:`build` compiles each ``*.cu`` file with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface under
``build/repro_torch_kernels/`` at the repository root, and loads it with
``ctypes`` (no PyTorch headers, so a build takes seconds). The build
runs at first use; a library whose name carries the hash of its sources,
the shared headers they include (``kernels/csrc/``, passed with ``-I``)
and the flags is reused. ``nvcc`` runs with ``--fmad=false``: a fused
multiply-add rounds once where the plain torch versions round twice, and
the LDA kernels must make the same draws as those versions. The flag
only stops the compiler from fusing a multiply and an add; a kernel
whose result is held to a tolerance (``flash_attention``) writes its
``fmaf`` calls out.

Every C entry point launches on the caller's stream and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
Nothing here is imported or built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

import torch

__all__ = ["BUILD_DIR", "KERNEL_NAMES", "build", "build_all", "load",
           "check", "stream_ptr", "require_cuda"]

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch_kernels"
KERNEL_NAMES = ("gossip_mix", "lda_gibbs", "lda_l2r", "lda_sparse",
                "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built on this machine")
    return found


def _shared_includes(text: str, seen: set[pathlib.Path]) -> None:
    """Add to ``seen`` the files of the shared directory that ``text``
    includes, in quotes or in angle brackets (``-I`` finds both), and
    theirs in turn."""
    for inc in re.findall(r'#\s*include\s*[<"]([^>"]+)[>"]', text):
        f = _PKG / "csrc" / inc
        if f.is_file() and f not in seen:
            seen.add(f)
            _shared_includes(f.read_text(), seen)


def _target(name: str) -> tuple[pathlib.Path, list[pathlib.Path]]:
    csrc = _PKG / name / "csrc"
    sources = sorted(csrc.glob("*.cu"))
    if len(sources) != 1:
        raise RuntimeError(f"kernel {name}: expected one .cu under {csrc}")
    own = sorted(csrc.glob("*.cu*"))
    shared: set[pathlib.Path] = set()
    for f in own:
        _shared_includes(f.read_text(), shared)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in own + sorted(shared):
        h.update(f.relative_to(_PKG).as_posix().encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so", sources


def _nvcc_args(sources: list[pathlib.Path], out: pathlib.Path) -> list[str]:
    """nvcc's arguments for one kernel (without the compiler itself)."""
    return [*NVCC_FLAGS, "-I", str(_PKG / "csrc"), "-o", str(out),
            *map(str, sources)]


def build_all(names=KERNEL_NAMES) -> dict[str, str]:
    """Compile every named kernel that is not built yet, all in parallel.

    Returns each kernel's ``nvcc`` output (``-Xptxas -v``: registers,
    shared memory, spills); raises on the first failed build.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib, sources = _target(name)
        if lib.exists():
            continue
        tmp = lib.parent / f"{lib.stem}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *_nvcc_args(sources, tmp)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    logs = {}
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        os.replace(tmp, lib)
    return logs


def build(name: str) -> pathlib.Path:
    """Path of the built library for one kernel, building it if needed."""
    build_all((name,))
    return _target(name)[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel (built at first use)."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: the kernel launch returned CUDA "
                           f"error {err}")


def stream_ptr() -> int:
    """The current CUDA stream of the current device, as an int."""
    return torch.cuda.current_stream().cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device and is contiguous."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: tensors must share one CUDA device, "
                         f"got {sorted(map(str, devs))}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
