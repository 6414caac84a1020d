"""Hand-written CUDA kernel for the fused 3-scale GroupDW correlation.

Counterpart of `usot_tpu/ops/pallas/xcorr_kernel.py::xcorr_groupdw_pallas`
(the TPU kernel, `:135`). The source is `csrc/xcorr_groupdw.cu`; its note
gives the kernel's design and its bound on an H100. It is compiled with
`nvcc -gencode arch=compute_90a,code=sm_90a` into a shared library with a
plain C interface at first use, into `usot_tpu_torch/_build/` (git-ignored)
under a name keyed by a hash of the source and flags, and bound with
`ctypes`.

`xcorr_groupdw_cuda` takes CUDA tensors only and raises on anything the
kernel does not take; the plain version for CPU tensors is
`usot_tpu_torch.ops.xcorr.xcorr_groupdw_reference`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "xcorr_groupdw.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def groupdw_out_hw(xs, ks):
    """Common (Ho, Wo) of the three scales; raises if they differ."""
    ho = xs[0].shape[1] - ks[0].shape[2] + 1
    wo = xs[0].shape[2] - ks[0].shape[3] + 1
    for x, k in zip(xs, ks):
        if (x.shape[1] - k.shape[2] + 1, x.shape[2] - k.shape[3] + 1) \
                != (ho, wo):
            raise ValueError("GroupDW scales disagree on the output size: "
                             f"{[tuple(t.shape) for t in (*xs, *ks)]}")
    return ho, wo


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the GroupDW kernel is built "
                           "on a machine with the CUDA toolkit")
    return found


def build() -> tuple[Path, str]:
    """Compile the kernel library if it is not built yet.

    Returns (path of the .so, compiler output; empty when cached)."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libxcorr_groupdw_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


_lib = None


def _library():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.usot_xcorr_groupdw
        # dtype, x0..x2, k0..k2, out, dims, stream
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(xs, ks):
    if len(xs) != 3 or len(ks) != 3:
        raise ValueError("GroupDW takes 3 search maps and 3 kernel stacks")
    dev, dtype = xs[0].device, xs[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"xcorr_groupdw_cuda takes CUDA tensors, got {dev}")
    if dtype not in _DTYPES:
        raise TypeError(f"xcorr_groupdw_cuda takes float32 or bfloat16, "
                        f"got {dtype}")
    b, m, c = ks[0].shape[0], ks[0].shape[1], ks[0].shape[4]
    for x, k in zip(xs, ks):
        for t in (x, k):
            if t.device != dev or t.dtype != dtype:
                raise ValueError("GroupDW inputs must share device and dtype")
            if not t.is_contiguous():
                raise ValueError("GroupDW inputs must be contiguous NHWC")
        if x.dim() != 4 or k.dim() != 5:
            raise ValueError("search maps are (B,H,W,C), kernels "
                             "(B,M,Hk,Wk,C)")
        if x.shape[0] != b or x.shape[3] != c or k.shape[0] != b \
                or k.shape[1] != m or k.shape[4] != c:
            raise ValueError("GroupDW B, M and C must agree across inputs: "
                             f"{[tuple(t.shape) for t in (*xs, *ks)]}")
    ho, wo = groupdw_out_hw(xs, ks)
    if ho < 1 or wo < 1:
        raise ValueError("GroupDW kernels are larger than the search maps")
    return b, m, c, ho, wo


def xcorr_groupdw_cuda(xs, ks):
    """Fused GroupDW on the GPU: xs 3 x (B, Hx_s, Wx_s, C), ks 3 x
    (B, M, Hk_s, Wk_s, C) -> (B, M, Ho, Wo, C), launched on the current
    stream. Counts its launches in `xcorr_groupdw_cuda.launches`."""
    b, m, c, ho, wo = _check(xs, ks)
    out = torch.empty((b, m, ho, wo, c), dtype=xs[0].dtype,
                      device=xs[0].device)
    dims = [b, m, c, ho, wo]
    for x, k in zip(xs, ks):
        dims += [x.shape[1], x.shape[2], k.shape[2], k.shape[3]]
    dims_c = (ctypes.c_int * len(dims))(*dims)
    lib = _library()
    with torch.cuda.device(xs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.usot_xcorr_groupdw(
            _DTYPES[xs[0].dtype], *(t.data_ptr() for t in xs),
            *(t.data_ptr() for t in ks), out.data_ptr(),
            ctypes.addressof(dims_c), stream)
    if err != 0:
        raise RuntimeError(f"GroupDW kernel launch failed: CUDA error {err}")
    xcorr_groupdw_cuda.launches += 1
    return out


xcorr_groupdw_cuda.launches = 0
