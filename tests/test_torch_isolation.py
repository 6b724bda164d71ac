"""The port stands alone: it imports no JAX and nothing of ``repro``, and
with no CUDA card its entry points refuse to run unless asked for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import build_model, reduce_config  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "tools").glob("torch_*.py")) \
    + [ROOT / "tools" / name for name in (
        "lint_invariants_torch.py", "chip_dist.py", "kernel_ablation.py",
        "probe_sac_route.py", "time_personalize.py",
        "time_train_offload.py", "profile_torch_serve.py")] \
    + sorted((ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")

torch.set_num_threads(1)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_or_reference(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_port_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(len(names))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 32    # every module was imported


# the pod layer's multi-card half: each is among the files checked above
MESH_MODULES = ("launch/mesh.py", "sharding/__init__.py", "sharding/rules.py",
                "sharding/api.py", "sharding/collectives.py",
                "train/pipeline.py", "launch/comm_analysis.py")


@pytest.mark.parametrize("module", MESH_MODULES)
def test_mesh_modules_are_checked(module):
    path = ROOT / "src" / "repro_torch" / module
    assert path in PORT_FILES
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_distributed_launch_refuses_without_a_card(no_card):
    """``--distributed`` runs NCCL on the card; without one it runs only
    when asked for the CPU (gloo)."""
    from repro_torch.launch import train as launch_train
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "llama3.2-3b", "--test-mesh",
                           "--distributed", "--steps", "1"])


def test_kernels_refuse_a_distributed_tensor():
    """The kernels read their operands through data pointers: a
    distributed tensor (one with ``to_local``) is refused before any
    launch, whatever its device."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.fused_swiglu import kernel as sw

    class Distributed(torch.Tensor):
        def to_local(self):
            return self.as_subclass(torch.Tensor)

    x = torch.zeros(1, 2, 8, 16).as_subclass(Distributed)
    with pytest.raises(TypeError, match="to_local"):
        fa.flash_attention_fwd(x, x, x)
    w = torch.zeros(16, 8).as_subclass(Distributed)
    with pytest.raises(TypeError, match="to_local"):
        sw.fused_swiglu(torch.zeros(4, 16), w, w)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA card")


def _tiny():
    return reduce_config(ARCHS["llama3.2-3b"])


def test_resolve_device_refuses_cpu_fallback(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_refuse_to_run_without_a_card(no_card):
    model = build_model(_tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.decode_init(2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({}, _tiny())
    assert model.init(0, device="cpu").embed.device == torch.device("cpu")


def test_zamba_entry_points_refuse_to_run_without_a_card(no_card):
    model = build_model(ARCHS["zamba2-7b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.decode_init(2, 8)


def test_moe_entry_points_refuse_to_run_without_a_card(no_card):
    model = build_model(ARCHS["granite-moe-1b-a400m"])
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.decode_init(2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({}, reduce_config(ARCHS["granite-moe-1b-a400m"]))


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_multimodal_entry_points_refuse_to_run_without_a_card(no_card,
                                                              arch):
    model = build_model(ARCHS[arch])
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.decode_init(2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({}, reduce_config(ARCHS[arch]))


def test_serve_cli_refuses_to_run_without_a_card(no_card, monkeypatch):
    monkeypatch.setattr("sys.argv", ["serve", "generate", "--arch",
                                     "llama3.2-3b", "--test-mesh"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main()


def test_chip_smoke_exits_nonzero_without_a_card(no_card):
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT)
    assert res.returncode != 0
    assert res.stdout == ""
