"""The port stands alone and has no hidden fallback.

* Importing every ``repro_torch`` module (and ``chip_smoke.py``) loads no
  ``jax`` and nothing of the reference package ``repro``.
* On a machine without a CUDA device every default-device entry point
  raises instead of quietly running on the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.models.model import build_model
from repro_torch.serve.engine import (ContinuousConfig, ContinuousEngine,
                                     ServeConfig, ServeEngine)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert "repro_torch.launch.serve" in names, names
assert "repro_torch.launch.train" in names, names
assert "repro_torch.core.quant" in names, names
assert "repro_torch.serve.kv_cache" in names, names
assert "repro_torch.analysis.lint" in names, names
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _PROBE,
                          str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.strip()) >= 20


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the no-fallback checks "
                    "are about machines without one")


def test_default_device_engine_raises_without_gpu():
    _require_no_cuda()
    model = build_model(get_smoke("smollm-135m"))      # default: cuda
    with pytest.raises(RuntimeError, match="CUDA device"):
        ContinuousEngine(model, ContinuousConfig(n_pages=9))


def test_default_device_lockstep_engine_raises_without_gpu():
    _require_no_cuda()
    model = build_model(get_smoke("smollm-135m"))      # default: cuda
    with pytest.raises(RuntimeError, match="CUDA device"):
        ServeEngine(model, ServeConfig(max_len=8))


def test_lockstep_cli_default_device_raises_without_gpu():
    _require_no_cuda()
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["--smoke", "--engine", "lockstep", "--batch", "1",
              "--prompt-len", "4", "--new-tokens", "2"])


def test_cli_default_device_raises_without_gpu():
    _require_no_cuda()
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["--smoke", "--batch", "1", "--prompt-len", "4",
              "--new-tokens", "2"])


def test_train_cli_default_device_raises_without_gpu():
    _require_no_cuda()
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["--smoke", "--steps", "1", "--seq", "32", "--batch", "1"])


def test_kernel_loader_raises_without_gpu():
    _require_no_cuda()
    from repro_torch.kernels import _build
    with pytest.raises(RuntimeError):
        _build.load("salo_paged_decode")
    with pytest.raises(RuntimeError):
        _build.load("salo_table_attention")
    with pytest.raises(RuntimeError):
        _build.load("salo_decode")
    with pytest.raises(RuntimeError):
        _build.build_all()
