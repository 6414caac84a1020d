"""Hand-written CUDA kernels for the depthwise correlations.

Counterparts of the three TPU kernels of
`usot_tpu/ops/pallas/xcorr_kernel.py`:

* K1 `xcorr_groupdw_cuda` (`csrc/xcorr_groupdw.cu`) <- the fused 3-scale
  GroupDW, `xcorr_groupdw_pallas` (`:135`);
* K2 `xcorr_depthwise_multi_cuda` (`csrc/xcorr_depthwise.cu`) <- one
  search map against M kernels, `xcorr_depthwise_multi_pallas` (`:65`);
* K3 `xcorr_depthwise_pairwise_cuda` (`csrc/xcorr_depthwise.cu`) <- the
  pairwise correlation, `xcorr_depthwise_pallas` (`:190`).

Both sources include one tiled accumulation routine,
`csrc/xcorr_tile.cuh`; its note and each source's give the design and
the bound on an H100. A source is compiled with `nvcc -gencode
arch=compute_90a,code=sm_90a` into a shared library with a plain C
interface at first use, into `usot_tpu_torch/_build/` (git-ignored)
under a name keyed by a hash of the source, the headers beside it and
the flags, and bound with `ctypes`; `build_all` compiles every source at
once, one `nvcc` each.

The wrappers take CUDA tensors only and raise on anything their kernel
does not take; the plain versions for CPU tensors are in
`usot_tpu_torch.ops.xcorr`. Each counts its launches in `.launches`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "xcorr_groupdw.cu"                 # K1
DEPTHWISE_SOURCE = CSRC / "xcorr_depthwise.cu"     # K2, K3
SOURCES = (SOURCE, DEPTHWISE_SOURCE)
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TAP = 8  # kMaxTap of csrc/xcorr_tile.cuh
# entry point -> (source, number of pointer arguments after the dtype)
_ENTRIES = {"usot_xcorr_groupdw": (SOURCE, 9),
            "usot_xcorr_depthwise_multi": (DEPTHWISE_SOURCE, 5),
            "usot_xcorr_depthwise": (DEPTHWISE_SOURCE, 5)}


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
        raise RuntimeError("nvcc not found: the correlation kernels are "
                           "built on a machine with the CUDA toolkit")
    return found


def library_path(source: Path = SOURCE) -> Path:
    """Where `source` is built: the name is keyed by a hash of the source,
    every header (`*.cuh`) beside it, which it may include, and the
    flags, so that a change to any of them builds anew."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def _compile(sources) -> dict:
    """Starts one nvcc per source that is not built yet, all at once, and
    waits for them. Returns {source: (library path, compiler output;
    empty when cached)}."""
    done, running = {}, []
    for source in sources:
        lib = library_path(source)
        if lib.exists():
            done[source] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((source, lib, tmp, proc))
    failures = []
    for source, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc {source.name} failed ({proc.returncode})"
                            f":\n{log}")
            continue
        os.replace(tmp, lib)
        done[source] = (lib, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return done


def build(source: Path = SOURCE) -> tuple[Path, str]:
    """Compile one kernel library if it is not built yet. Returns (path
    of the .so, compiler output; empty when cached)."""
    return _compile([source])[source]


def build_all() -> dict:
    """Compile every kernel source in parallel. Returns {source file name:
    (path of the .so, compiler output; empty when cached)}."""
    return {s.name: v for s, v in _compile(SOURCES).items()}


_libs: dict = {}


def _entry(name: str):
    source, n_ptr = _ENTRIES[name]
    lib = _libs.get(source)
    if lib is None:
        path, _ = build(source)
        lib = _libs[source] = ctypes.CDLL(str(path))
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptr
    fn.restype = ctypes.c_int
    return fn


def _check_taps(name: str, kernels):
    """The kernels keep a tap row in registers, so their taps are at most
    MAX_TAP x MAX_TAP (`csrc/xcorr_tile.cuh`)."""
    for k in kernels:
        if k.dim() >= 3 and max(k.shape[-3], k.shape[-2]) > MAX_TAP:
            raise ValueError(f"{name} takes kernels of at most {MAX_TAP} x "
                             f"{MAX_TAP} taps, got {tuple(k.shape)}")


def _check_tensors(name: str, tensors):
    """Device, type and contiguity checks shared by the wrappers."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {dev}")
    if dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {dtype}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} inputs must share device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name} inputs must be contiguous NHWC")


def _launch(name: str, dtype, pointers, dims, device):
    dims_c = (ctypes.c_int * len(dims))(*dims)
    fn = _entry(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[dtype], *pointers, ctypes.addressof(dims_c), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _check_groupdw(xs, ks):
    if len(xs) != 3 or len(ks) != 3:
        raise ValueError("GroupDW takes 3 search maps and 3 kernel stacks")
    _check_taps("xcorr_groupdw_cuda", ks)
    _check_tensors("xcorr_groupdw_cuda", [*xs, *ks])
    b, m, c = ks[0].shape[0], ks[0].shape[1], ks[0].shape[4]
    for x, k in zip(xs, ks):
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
    """K1, fused GroupDW on the GPU: xs 3 x (B, Hx_s, Wx_s, C), ks 3 x
    (B, M, Hk_s, Wk_s, C) -> (B, M, Ho, Wo, C), launched on the current
    stream. Counts its launches in `xcorr_groupdw_cuda.launches`."""
    b, m, c, ho, wo = _check_groupdw(xs, ks)
    out = torch.empty((b, m, ho, wo, c), dtype=xs[0].dtype,
                      device=xs[0].device)
    dims = [b, m, c, ho, wo]
    for x, k in zip(xs, ks):
        dims += [x.shape[1], x.shape[2], k.shape[2], k.shape[3]]
    _launch("usot_xcorr_groupdw", xs[0].dtype,
            [t.data_ptr() for t in (*xs, *ks, out)], dims, xs[0].device)
    xcorr_groupdw_cuda.launches += 1
    return out


def _check_single(name: str, x, kernel, kernel_dim: int):
    """Shapes of a single-scale correlation; returns (B, C, Ho, Wo)."""
    _check_taps(name, [kernel])
    _check_tensors(name, [x, kernel])
    if x.dim() != 4 or kernel.dim() != kernel_dim:
        raise ValueError(f"{name}: search map (B,H,W,C) and kernels of "
                         f"{kernel_dim} dims, got {tuple(x.shape)} and "
                         f"{tuple(kernel.shape)}")
    b, hx, wx, c = x.shape
    hk, wk = kernel.shape[-3], kernel.shape[-2]
    if kernel.shape[0] != b or kernel.shape[-1] != c:
        raise ValueError(f"{name}: B and C must agree: {tuple(x.shape)} "
                         f"and {tuple(kernel.shape)}")
    ho, wo = hx - hk + 1, wx - wk + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"{name}: kernels larger than the search map")
    return b, c, ho, wo


def xcorr_depthwise_multi_cuda(x, kernel):
    """K2 on the GPU: x (B, Hx, Wx, C), kernel (B, M, Hk, Wk, C) ->
    (B, M, Ho, Wo, C) VALID, launched on the current stream. Counts its
    launches in `xcorr_depthwise_multi_cuda.launches`."""
    name = "xcorr_depthwise_multi_cuda"
    b, c, ho, wo = _check_single(name, x, kernel, 5)
    m = kernel.shape[1]
    out = torch.empty((b, m, ho, wo, c), dtype=x.dtype, device=x.device)
    dims = [b, m, c, x.shape[1], x.shape[2], kernel.shape[2],
            kernel.shape[3]]
    _launch("usot_xcorr_depthwise_multi", x.dtype,
            [x.data_ptr(), kernel.data_ptr(), out.data_ptr()], dims,
            x.device)
    xcorr_depthwise_multi_cuda.launches += 1
    return out


def xcorr_depthwise_pairwise_cuda(x, kernel):
    """K3 on the GPU: x (B, Hx, Wx, C), kernel (B, Hk, Wk, C) ->
    (B, Ho, Wo, C) VALID, launched on the current stream. Counts its
    launches in `xcorr_depthwise_pairwise_cuda.launches`."""
    name = "xcorr_depthwise_pairwise_cuda"
    b, c, ho, wo = _check_single(name, x, kernel, 4)
    out = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    dims = [b, c, x.shape[1], x.shape[2], kernel.shape[1], kernel.shape[2]]
    _launch("usot_xcorr_depthwise", x.dtype,
            [x.data_ptr(), kernel.data_ptr(), out.data_ptr()], dims,
            x.device)
    xcorr_depthwise_pairwise_cuda.launches += 1
    return out


_WRAPPERS = {"K1": xcorr_groupdw_cuda, "K2": xcorr_depthwise_multi_cuda,
             "K3": xcorr_depthwise_pairwise_cuda}
for _fn in _WRAPPERS.values():
    _fn.launches = 0


def launch_counts() -> dict:
    """{"K1": n, "K2": n, "K3": n}: the wrappers' launch counters."""
    return {tag: fn.launches for tag, fn in _WRAPPERS.items()}


def reset_launch_counts():
    for fn in _WRAPPERS.values():
        fn.launches = 0
