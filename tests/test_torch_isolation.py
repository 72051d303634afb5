"""The port stands alone: importing every module of ``nnuzoo_tpu_torch``
loads neither JAX, flax, optax, msgpack, PIL nor any module of the JAX
package (the GPU machine has no flax or msgpack, and PIL is imported only
where an image is read or written), and its entry points refuse to run on a
CUDA device that is not there."""

import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import nnuzoo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nnuzoo_tpu_torch.__path__,
                                               "nnuzoo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack",
                                    "PIL", "nnuzoo_tpu"))
print(len(names), bad)
for wanted in ("training.trainer", "training.losses", "training.schedulers",
               "training.trainer_config", "training.logger", "data.augment",
               "data.dataset", "data.patch_sampler", "data.loader",
               "run.run_training", "ops.cross_scan", "ops.selective_scan",
               "models.ss2d", "imageio.registry", "imageio.natural",
               "imageio.tiff", "evaluation.metrics", "utilities.flax_msgpack",
               "utilities.dataset_utils", "cli.entry_points", "cli.__main__",
               "planning.api", "planning.planner", "planning.fingerprint",
               "utilities.json_export", "run.load_pretrained_weights",
               "models.dynamic_unet", "models.u2net", "models.registry",
               "models.mamba", "models.unetr", "models.light_munet",
               "models.seg_mamba", "models.swin_umamba", "models.attention",
               "models.swt", "models.x2net", "ops.ssd", "models.lm2net",
               "models.ssnd", "models.mixers", "models.ssnd2net"):
    assert "nnuzoo_tpu_torch." + wanted in names, wanted
"""


def test_import_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 35          # every module was imported
    assert bad == "[]", bad


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


def test_default_device_raises_without_cuda(no_cuda):
    from nnuzoo_tpu_torch._device import resolve_device
    from nnuzoo_tpu_torch.inference.predictor import Predictor
    from nnuzoo_tpu_torch.models.registry import get_model_builder
    from nnuzoo_tpu_torch.plans.plans_handler import PlansManager

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor()
    pm = PlansManager({"configurations": {"2d": {"patch_size": [32, 32]}}})
    dj = {"labels": {"background": 0, "a": 1}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model_builder("nnUNetTrainerM2NetP")(
            pm, dj, pm.get_configuration("2d"), 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu").type == "cpu"
    Predictor(device="cpu")


def test_cli_defaults_to_cuda_and_raises_without_it(no_cuda, tmp_path, monkeypatch):
    from nnuzoo_tpu_torch.cli.entry_points import main
    monkeypatch.setenv("nnUNet_results", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["predict", "-i", str(tmp_path), "-o", str(tmp_path / "out"),
              "-d", "Dataset999_Port", "-c", "2d"])
    out = subprocess.run([sys.executable, "-m", "nnuzoo_tpu_torch.cli"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "train,predict,evaluate_folder" in out.stderr


def test_no_source_line_imports_the_jax_side():
    """No module of the port names ``jax``, ``flax``, ``optax``, ``msgpack``
    or the JAX package in an import statement, not even inside a function."""
    import re
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax|msgpack|"
                         r"nnuzoo_tpu)(\.|\s|$)")
    files = list((REPO / "nnuzoo_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 40
    bad = [(str(f.relative_to(REPO)), line.strip()) for f in files
           for line in f.read_text().splitlines() if pattern.match(line)]
    assert bad == []
