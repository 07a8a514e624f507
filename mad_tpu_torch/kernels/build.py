"""Build and load the hand-written CUDA kernels of ``mad_tpu_torch/csrc``.

Every ``csrc/*.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` call links the objects into a shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), loaded with ``ctypes``. The library goes to
``mad_tpu_torch/_build/`` (git-ignored), named by a hash of the sources
and flags, so an unchanged checkout builds once and a changed source
rebuilds. Nothing here runs at import time: the first CUDA call of a
kernel wrapper triggers the build, and a failed build raises.

Every exported function launches on the stream it is given and returns
``cudaGetLastError()`` after the launch; the wrappers call it through
:func:`launch`, which makes the inputs' card current around the call and
raises on a non-zero code; in the sanitizer's global mode
(``MAD_TPU_NANCHECK=global``) it also synchronizes and checks the
launch's floating tensors (``utils/sanitize.check_launch``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

from ..utils import sanitize

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
SMEM_LIMIT = 232448     # bytes of shared memory a block may use (sm_90)
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
_L = ctypes.c_longlong

# C signatures of the exported launchers (csrc/*.cu, extern "C"); each
# ends with the stream, a pointer.
SIGNATURES = {
    "mad_conv1d": [_P, _P, _P, _I, _L, _I, _I, _I, _I, _P, _P, _L, _P],
    "mad_log_pass": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                     _P],
    "mad_peak_mask_compact": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                              _F, _P, _I, _P, _L, _P, _P, _P, _I, _P],
    "mad_descriptor_hist": [_P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P, _P, _P, _I, _I, _I, _P, _P, _I, _P, _I,
                            _P, _I, _P, _P, _I, _F, _F, _P, _P, _P],
    "mad_exact_repeat": [_P, _I, _P, _I, _P, _P, _P, _I, _F, _P, _P, _P],
    "mad_scatter_atoms": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P, _L, _P, _P, _P, _P],
    "mad_simulate_scale": [_P, _I, _L, _P, _F, _I, _P],
    "mad_pack_overlap": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "mad_enumerate_head": [_P, _I, _P, _I, _I, _L, _I, _I, _P, _P, _P],
    "mad_hetero_head": [_P, _I, _I, _P, _I, _P, _I, _L, _I, _I, _P, _P, _P],
    "mad_orient": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I,
                   _P, _P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _F,
                   _P, _P, _P, _P, _P],
    "mad_refine": [_P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _F,
                   _F, _P, _P, _P, _P, _P, _P, _P],
    "mad_pair_head": [_P, _I, _I, _I, _F, _I, _L, _P, _P, _P, _P, _P],
    "mad_pair_merge": [_P, _L, _L, _P, _P, _P, _P],
    "mad_anchor_field": [_P, _I, _I, _I, _I, _I, _P, _P],
    "mad_approx_repeat": [_P, _I, _I, _I, _P, _I, _I, _P, _I, _P, _F, _P,
                          _P, _P, _I, _P, _P],
    "mad_cluster_select": [_P, _P, _P, _P, _P, _P, _I, _D, _I, _D, _I, _P,
                           _P, _P, _P, _P],
    "mad_upsample2": [_P, _P, _I, _I, _I, _L, _P],
    "mad_gradient": [_P, _I, _I, _I, _I, _P, _L, _P],
    "mad_localize": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                     _F, _I, _I, _I, _P, _P, _P, _P],
    "mad_gather_norm": [_P, _P, _I, _P, _I, _I, _P, _P, _I, _P],
    "mad_post_lanes": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _I, _P,
                       _I, _D, _P, _P, _P, _P],
    "mad_post_lanes_dedup": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I,
                             _P, _I, _D, _P, _I, _P, _I, _D, _P, _P, _P, _P,
                             _P, _P, _P, _P, _P],
    "mad_post_dedup": [_P, _P, _P, _I, _I, _P, _I, _P, _I, _D, _P, _P, _P,
                       _P, _P],
    "mad_post_points": [_P, _I, _I, _P, _I, _P, _P, _I, _I, _D, _I, _P, _P,
                        _P],
    "mad_post_rows": [_P, _I, _I, _P, _I, _P, _P, _I, _P, _P, _I, _I, _D,
                      _P, _P],
    "mad_post_compact": [_P, _I, _I, _P, _P],
    "mad_batched_ccc": [_P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _I, _P, _P,
                        _P],
    "mad_select_exact": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "mad_axis_flags": [_P, _I, _I, _I, _P, _P],
    "mad_crop_pad": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None      # wall time of the build this process ran (or 0)
build_log = ""            # nvcc's output (ptxas register / smem report)


def constants(source: str) -> dict:
    """The ``constexpr int`` values of ``csrc/<source>`` by name (integer
    literals and arithmetic on earlier ones), read from the source text so
    that the host side's copy of a kernel's tiling cannot go stale; no
    build needed."""
    text = re.sub(r"//[^\n]*", "", (CSRC / source).read_text())
    out = {}
    for decl in re.findall(r"\bconstexpr\s+int\s+([^;]+);", text):
        for item in decl.split(","):
            name, expr = (s.strip() for s in item.split("=", 1))
            expr = re.sub(r"\b[A-Za-z_]\w*\b",
                          lambda m: str(out.get(m.group(), m.group())), expr)
            if re.fullmatch(r"[\d\s+\-*/%()]+", expr):
                out[name] = int(eval(expr.replace("/", "//")))
    return out


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (CUDA_HOME unset, no nvcc)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _compile_and_link(srcs, so: Path) -> str:
    """nvcc -c of every source in parallel, then one -shared link; the
    library appears under its final name only when all steps passed."""
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"{so.stem}.tmp{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    objs = [tmp / f"{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen([nvcc] + ARCH_FLAGS + NVCC_FLAGS
                              + ["-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    logs, failed = [], []
    for src, proc in zip(srcs, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        lib_tmp = tmp / so.name
        proc = subprocess.run([nvcc] + ARCH_FLAGS + ["-shared", "-o",
                                                     str(lib_tmp)]
                              + [str(o) for o in objs],
                              capture_output=True, text=True)
        logs.append(f"== link\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append("link")
        else:
            os.replace(lib_tmp, so)
            shutil.rmtree(tmp, ignore_errors=True)
    log = "".join(logs)
    (BUILD_DIR / "nvcc.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        srcs, hdrs = _sources()
        h = hashlib.sha1()
        for f in srcs + hdrs:
            h.update(f.name.encode())
            h.update(f.read_bytes())
        h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"libmad_kernels_{h.hexdigest()[:16]}.so"
        t0 = time.perf_counter()
        if not so.exists():
            build_log = _compile_and_link(srcs, so)
        build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.mad_error_string.argtypes = [_I]
        lib.mad_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def launch(fn, device, *args) -> None:
    """Call the exported launcher ``fn`` with ``args`` and the current
    stream of ``device``, with ``device`` made the current card for the
    call (a launch goes to the current card, which need not be the
    inputs': a mesh's shards, a session on cuda:1); raise on its error
    code. ``args`` must fill every parameter but the stream: ctypes would
    pass an argument beyond ``fn.argtypes`` as a C int, cutting the stream
    handle to 32 bits."""
    import torch
    if len(fn.argtypes) != len(args) + 1:
        raise TypeError(f"{fn.__name__}: {len(args)} arguments and the "
                        f"stream for {len(fn.argtypes)} parameters")
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        msg = _lib.mad_error_string(code).decode()
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed: {msg} "
                           f"({code})")
    if sanitize.mode() == "global":
        sanitize.check_launch(fn.__name__, device,
                              _given(args, sys._getframe(1).f_locals))


def _given(args, scope) -> list:
    """The tensors of the calling wrapper's ``scope`` whose data the
    launch's ``args`` point at (the wrappers pass ``data_ptr()`` ints)."""
    import torch
    ptrs = {a for a in args if isinstance(a, int) and a}
    seen, out = set(), []

    def visit(v):
        if isinstance(v, (list, tuple)):
            for x in v:
                visit(x)
        elif (isinstance(v, torch.Tensor) and v.is_cuda
              and v.data_ptr() in ptrs and id(v) not in seen):
            seen.add(id(v))
            out.append(v)
    for v in scope.values():
        visit(v)
    return out


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
