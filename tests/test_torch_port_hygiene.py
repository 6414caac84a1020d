"""The port stands alone: it imports no JAX, no flax and nothing of
`usot_tpu`, and its entry points never fall back to the CPU quietly."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "usot_tpu_torch")


def _forbidden(name: str) -> bool:
    # `usot_tpu_torch` starts with `usot_tpu`: match the package exactly
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "usot_tpu")


def test_importing_every_module_loads_no_jax():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import usot_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            usot_tpu_torch.__path__, "usot_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        print(len(names))
        print("\\n".join(sorted(sys.modules)))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300,
                          check=True)
    lines = proc.stdout.split()
    assert int(lines[0]) >= 20  # every sub-package and module was imported
    loaded = lines[1:]
    assert "usot_tpu_torch.tracker.tracker" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_no_source_file_names_jax():
    """Static check of the port (its benchmark tools included),
    `chip_smoke.py` and the port's profiling tool, including imports
    inside functions."""
    paths = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tools", "profile_port_slice.py")]
    for dirpath, _, files in os.walk(PORT):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    assert len(paths) > 20
    for tool in ("bench_xcorr.py", "bench_memhead.py", "profile_engine.py",
                 "timing.py"):
        assert os.path.join(PORT, "tools", tool) in paths
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from usot_tpu_torch.models.usot import build_usot, init_model
    from usot_tpu_torch.tracker.runner import ModelRunner

    model = build_usot(width=4, channels=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelRunner(model)
    init_model(model, device="cpu")
    assert ModelRunner(model, device="cpu").device.type == "cpu"


def test_groupdw_kernel_source_is_for_hopper():
    """The kernel is CUDA C++ built for sm_90a from the repo's source:
    an entry point over the tiled kernel of `xcorr_tile.cuh`."""
    from usot_tpu_torch.ops import xcorr_kernel

    assert xcorr_kernel.SOURCE.exists()
    assert "arch=compute_90a,code=sm_90a" in xcorr_kernel.NVCC_FLAGS
    src = xcorr_kernel.SOURCE.read_text()
    tile = (xcorr_kernel.CSRC / "xcorr_tile.cuh").read_text()
    assert '#include "xcorr_tile.cuh"' in src and 'extern "C"' in src
    assert "__global__" in tile and "launch<3>" in src
    assert "xcorr_groupdw_pallas" in src  # names the TPU kernel it replaces


def test_depthwise_kernel_source_is_for_hopper():
    """K2 and K3 are CUDA C++ built for sm_90a from the repo's source,
    each entry point naming the TPU kernel it replaces."""
    from usot_tpu_torch.ops import xcorr_kernel

    src = xcorr_kernel.DEPTHWISE_SOURCE.read_text()
    assert xcorr_kernel.DEPTHWISE_SOURCE in xcorr_kernel.SOURCES
    assert "arch=compute_90a,code=sm_90a" in xcorr_kernel.NVCC_FLAGS
    tile = (xcorr_kernel.CSRC / "xcorr_tile.cuh").read_text()
    assert '#include "xcorr_tile.cuh"' in src and "__global__" in tile
    assert src.count('extern "C"') == 2 and "launch<1>" in src
    assert "usot_xcorr_depthwise_multi  <- xcorr_depthwise_multi_pallas" \
        in src
    assert "usot_xcorr_depthwise        <- xcorr_depthwise_pallas" in src


def test_engines_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from usot_tpu_torch.models.usot import build_usot
    from usot_tpu_torch.tracker.config import TrackerConfig
    from usot_tpu_torch.tracker.engine import BatchScanEngine, ScanEngine

    model = build_usot(width=4, channels=8)
    p = TrackerConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        ScanEngine(model, p, 64, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchScanEngine(model, p, 64, 64, batch=2)
    assert ScanEngine(model, p, 64, 64, device="cpu").device.type == "cpu"
    engine = BatchScanEngine(model, p, 64, 64, batch=2, device="cpu")
    assert engine._consts["window"].device.type == "cpu"
