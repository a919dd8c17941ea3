"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a``, then the objects are linked into one
shared library with a plain C interface, which is loaded with ``ctypes``.
No source includes PyTorch's headers, so a cold build takes seconds. The
library lands in ``shadowkv_tpu_torch/build/`` (git-ignored), named by a
hash of the sources, headers and flags, so an edited source or header
rebuilds and an unchanged one is reused. The library is linked without
``-lcuda``: the one driver entry point it needs (``cuTensorMapEncodeTiled``,
for the attention kernels' TMA maps) is fetched through the runtime.
``-Xptxas -v`` output (registers, shared memory, spills per kernel) is kept
beside it in ``nvcc.log``. Under a profiler the build is the host span
``skv.kernels.build``.

Nothing here runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from shadowkv_tpu_torch.utils import profiling

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("refresh.cu", "prefill_attention.cu", "gather.cu", "vs_tile.cu",
           "vs_sparse.cu", "spans.cu", "decode_attention.cu", "select.cu")
# included by the attention kernels (B, C, F, G)
HEADERS = ("flash_sm90.cuh",)
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# No --use_fast_math: the refresh kernel's RoPE needs precise sincosf at
# angles of ~1e5 rad.
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "shadowkv_sparse_refresh": ([_P] * 11 + [_I] * 12 + [_P], _I),
    "shadowkv_sparse_refresh_smem_bytes": ([_I, _I], ctypes.c_longlong),
    "shadowkv_prefill_attention": (
        [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P], _I
    ),
    "shadowkv_prefill_attention_offset": (
        [_P] * 4 + [_I] * 7 + [ctypes.c_float, _P], _I
    ),
    "shadowkv_sparse_prefill_attention": (
        [_P] * 4 + [_I] * 5 + [ctypes.c_float] + [_I] * 2 + [_P], _I
    ),
    "shadowkv_gather_chunks": ([_P] * 9 + [_I] * 7 + [_P], _I),
    "shadowkv_gather_v_rows": ([_P] * 4 + [_I] * 6 + [_P], _I),
    "shadowkv_vs_sparse_attention": (
        [_P] * 8 + [_I] * 5 + [ctypes.c_float, _P], _I
    ),
    "shadowkv_vs_tile_attention": (
        [_P] * 9 + [_I] * 7 + [ctypes.c_float, _P], _I
    ),
    "shadowkv_decode_attention": (
        [_P] * 6 + [ctypes.c_longlong] * 3 + [_I] * 8 + [ctypes.c_float, _P],
        _I
    ),
    "shadowkv_decode_attention_plan": ([_I] * 5 + [_P], _I),
    "shadowkv_select": (
        [_P] * 10 + [ctypes.c_longlong] * 5 + [_I] * 8
        + [_P, ctypes.c_float, _P], _I
    ),
    "shadowkv_select_device": ([_P], _I),
    "shadowkv_span": ([_I, _P], _I),
    "shadowkv_graph_upload": ([_P, _P], _I),
}

_lib = None  # the loaded library; one per process


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels are built on the machine with the card"
        )
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libshadowkv_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources (in parallel) and link the shared library;
    returns its path. Reuses an existing build of the same sources."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with profiling.span(profiling.KERNELS_BUILD), \
            tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *CFLAGS, "-c", str(CSRC_DIR / name), "-o", str(obj)]
            procs.append(
                (name, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ))
            )
        log = []
        failed = []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(log)
            )
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", *[str(o) for _, o, _ in procs],
             "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check_v_store(v_full, device, what: str) -> None:
    """A V store the kernels can read: contiguous, and on ``device`` or in
    pinned host memory (a kernel reads pageable memory wrongly or not at
    all)."""
    if not v_full.is_contiguous():
        raise ValueError(f"{what}: v_full must be contiguous")
    if v_full.is_cuda:
        if v_full.device != device:
            raise ValueError(f"{what}: v_full on another device")
    elif not v_full.is_pinned():
        raise ValueError(f"{what}: a CPU v_full must be pinned "
                         "(torch.empty(..., pin_memory=True)); the kernel "
                         "cannot read pageable memory")


HEAD_DIM = 128  # the head_dim the attention kernels (B, C, F, G) compute in


def pad_head_dim(tensors, what: str):
    """``tensors`` zero-padded on the last axis from their head_dim to
    HEAD_DIM (unchanged at HEAD_DIM). Zero lanes leave Q K^T unchanged and
    give zero output lanes, so the kernel computes the same function on the
    padded rows when it is given the softmax scale of the true head_dim,
    and the caller slices the output back. A head_dim above HEAD_DIM
    raises."""
    dh = tensors[0].shape[-1]
    if any(t.shape[-1] != dh for t in tensors):
        raise ValueError(f"{what}: q/k/v head_dims differ")
    if dh > HEAD_DIM:
        raise ValueError(f"{what}: the kernel serves head_dim <= {HEAD_DIM} "
                         f"(smaller ones are zero-padded to {HEAD_DIM}), "
                         f"got {dh}")
    if dh == HEAD_DIM:
        return tuple(tensors)
    return tuple(torch.nn.functional.pad(t, (0, HEAD_DIM - dh))
                 for t in tensors)


def unpad_head_dim(out, dh: int):
    """A kernel's output sliced back from HEAD_DIM to the caller's head_dim
    ``dh`` (contiguous)."""
    return out if dh == HEAD_DIM else out[..., :dh].contiguous()


def check_rows(q, k, v, what: str):
    """q [BH, S_pad, Dh] and k/v [BKV, S_pad, Dh] as the sparse prefill
    kernels read them through TMA: contiguous bf16 on the card, Dh <=
    HEAD_DIM, starting on a 16-byte boundary. Returns them padded to
    HEAD_DIM (``pad_head_dim``)."""
    for t in (q, k, v):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{what}: q/k/v must be contiguous bf16 CUDA "
                             "tensors")
    if q.dim() != 3 or k.shape[1:] != q.shape[1:] or v.shape != k.shape:
        raise ValueError(f"{what}: kernel serves q [BH, S, Dh], k/v "
                         f"[BKV, S, Dh]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    q, k, v = pad_head_dim((q, k, v), what)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: q/k/v must start on a 16-byte boundary "
                         "(TMA)")
    return q, k, v


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
