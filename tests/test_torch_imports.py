"""Import boundary of the PyTorch port: ``src/repro_torch`` and
``chip_smoke.py`` import neither JAX nor the JAX package, and the
port's entry points never fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_has_the_main_path_modules():
    rel = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for mod in ("approx/quant.py", "approx/registry.py", "approx/specs.py",
                "approx/backend.py", "approx/layers.py",
                "approx/workload.py", "approx/resilience.py",
                "approx/dse.py", "kernels/ops.py", "kernels/ref.py",
                "kernels/datapaths.py", "kernels/fused_matmul.py",
                "kernels/composed_matmul.py", "kernels/bitsim.py",
                "core/evolve_pop.py", "core/build_library.py",
                "models/resnet.py", "models/weights.py",
                "launch/case_study.py", "launch/wide_pareto.py",
                "kernels/lowrank_matmul.py", "models/common.py",
                "models/decoder.py", "models/registry.py",
                "configs/__init__.py", "configs/qwen1_5_0_5b.py",
                "launch/steps.py", "serve/__init__.py", "serve/engine.py",
                "launch/serve.py", "train/optimizer.py",
                "train/compression.py", "train/checkpoint.py",
                "train/loop.py", "launch/train.py",
                "launch/train_resnet.py", "launch/objectives_pareto.py",
                "launch/evolve_library.py"):
        assert mod in rel, mod
    from repro_torch.kernels.build import KERNELS
    from repro_torch.kernels.ops import launch_counts
    assert len(KERNELS) == 11
    assert set(launch_counts()) == set(KERNELS)
    for name in KERNELS:
        assert (PORT / "kernels" / "csrc" / f"{name}.cu").exists(), name


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_entry_points_without_cuda_raise(monkeypatch):
    from repro_torch.approx.workload import classification
    from repro_torch.device import resolve_device
    from repro_torch.launch import case_study
    from repro_torch.models import resnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    cfg = resnet.resnet_config(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        classification(cfg, resnet.ResNet(cfg), eval_n=8, batch=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        case_study.run()
    from repro_torch.launch import wide_pareto
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wide_pareto.run()
    from repro_torch.core import build_library
    from repro_torch.core.library import build_default_library
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_default_library("tiny", engine="device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_library.run("tiny", "device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_library.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_library.main([])
    from repro_torch.core.evolve_pop import PopEvaluator
    from repro_torch.core.cgp import CgpParams
    from repro_torch.core.seeds import ripple_carry_adder
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PopEvaluator(ripple_carry_adder(4), CgpParams(), engine="device")
    from repro_torch.kernels import ops
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.bitsim(ripple_carry_adder(4), np.zeros((8, 1), np.uint64))
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([])
    qa = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.lowrank_matmul(qa.to("meta"), torch.zeros(
            (3, 2), dtype=torch.int32, device="meta"),
            *(torch.ones((4, 256), device="meta"),) * 2)
    assert resolve_device("cpu") == torch.device("cpu")


def test_training_and_study_entry_points_without_cuda_raise(monkeypatch):
    from repro_torch.approx.workload import lm_perplexity
    from repro_torch.launch import (evolve_library, objectives_pareto,
                                    train, train_resnet)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (train.run, train_resnet.run, train_resnet.train,
                 objectives_pareto.run, evolve_library.run,
                 lambda: train.main([]), lambda: train_resnet.main([]),
                 lambda: objectives_pareto.main([]),
                 lambda: evolve_library.main([]),
                 lambda: lm_perplexity("qwen1.5-0.5b")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """chip_smoke.py copied into an empty directory (or run without a
    GPU) exits nonzero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
