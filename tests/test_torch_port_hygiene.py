"""Boundaries of the PyTorch port (signaltrain_tpu_torch) and chip_smoke.py.

* Neither imports JAX, flax, optax or anything of signaltrain_tpu (AST scan),
  and the package imports in a fresh interpreter where those are blocked.
* Entry points raise without CUDA unless given device="cpu": no silent move
  to the CPU.
* Every directory of the port that holds .py files is a package that
  setuptools discovers.
* chip_smoke.py exits non-zero and prints no result without a card, and when
  it stands alone in a directory.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from setuptools import find_packages

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "signaltrain_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "signaltrain_tpu"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
        "import importlib, pkgutil, signaltrain_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 31


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-CUDA error cannot be shown here")
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.models.st_model import st_model
    from signaltrain_tpu_torch.utils.load_model import load_model

    ckpt = str(REPO / "demo" / "model_comp4c_demo.tar")
    for call in (lambda: st_model(), lambda: load_model(ckpt), lambda: effects.Compressor_4c(),
                 lambda: effects.make_effect("comp_4c")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    st_model(device="cpu")
    effects.Compressor_4c(device="cpu")


def test_training_entry_points_need_cuda_or_an_explicit_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-CUDA error cannot be shown here")
    from signaltrain_tpu_torch.cli import run_train
    from signaltrain_tpu_torch.dsp import effects
    from signaltrain_tpu_torch.training.train import train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(effects.Compressor_4c(device="cpu"), epochs=1, n_data_points=8, batch_size=8)
    with pytest.raises(SystemExit) as e:  # the CLI's default device is the card too
        run_train.main(["--epochs", "1", "-n", "8", "-b", "8"])
    assert e.value.code == 1 and "device='cpu'" in capsys.readouterr().out
    # the file datasets' entry points: the dataset tool, the file effect, the run config
    from signaltrain_tpu_torch import config
    from signaltrain_tpu_torch.cli import gen_dataset

    with pytest.raises(SystemExit) as e:
        gen_dataset.main([str(REPO / "build" / "never_written"), "-n", "1"])
    assert e.value.code == 1 and "device='cpu'" in capsys.readouterr().out
    assert not (REPO / "build" / "never_written").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        effects.make_effect("files", path=str(REPO / "demo"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.train_from_config(config.RunConfig(epochs=1, n_data_points=8, batch_size=8))
    with pytest.raises(SystemExit) as e:
        run_train.main(["--path", str(REPO / "demo"), "-e", "files"])
    assert e.value.code == 1 and "device='cpu'" in capsys.readouterr().out


def test_every_port_directory_is_a_discovered_package():
    found = set(find_packages(str(REPO), include=["signaltrain_tpu*"]))
    for d in [PORT, *[p for p in PORT.rglob("*") if p.is_dir()]]:
        if d.name == "__pycache__" or not any(d.glob("*.py")):
            continue
        name = ".".join(d.relative_to(REPO).parts)
        assert (d / "__init__.py").is_file(), name
        assert name in found, name


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env=env)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
