"""Guards of the port's boundary: jointpose_torch and its scripts import
nothing of JAX or of the JAX package, the port's copied configs equal the
reference's, and entry points refuse to run without CUDA unless asked for
the CPU.

Imports are checked in the source (AST), not through sys.modules: the
test process imports JAX anyway."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

import jointpose.configs as jax_configs
import jointpose.skeleton as jax_skeleton
from jointpose_torch import configs, skeleton
from jointpose_torch.predict import build_predictor, init_state_dict, resolve_device
from jointpose_torch.train import create_state

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "jointpose"}


def _port_sources() -> list[Path]:
    scripts = [ROOT / "chip_smoke.py", *sorted(ROOT.glob("profile_*.py"))]
    return sorted((ROOT / "jointpose_torch").rglob("*.py")) + scripts


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            roots |= {a.value.split(".")[0] for a in node.args[:1] if isinstance(a, ast.Constant)}
    return roots


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_import_guard_sees_forbidden_imports(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\ndef f():\n    from jointpose.ops import mrf_xla\n    import flax.linen\n")
    assert _imported_roots(bad) & FORBIDDEN == {"jointpose", "flax"}


@pytest.mark.parametrize("name", sorted(jax_configs.PRESETS))
def test_presets_equal_reference(name):
    assert sorted(configs.PRESETS) == sorted(jax_configs.PRESETS)
    assert dataclasses.asdict(configs.get_config(name)) == dataclasses.asdict(
        jax_configs.get_config(name)
    )


def test_skeleton_equals_reference():
    for attr in ("JOINTS", "NUM_JOINTS", "JOINT_INDEX", "FLIP_PERM", "LIMBS", "TORSO_PAIR",
                 "HEADLINE_JOINTS"):
        assert getattr(skeleton, attr) == getattr(jax_skeleton, attr), attr


def test_flic_columns_equal_reference():
    from jointpose.data import flic as jax_flic
    from jointpose_torch.data import flic

    assert flic._FLIC_COLUMNS == jax_flic._FLIC_COLUMNS


def test_fit_modules_are_among_the_guarded_sources():
    names = {str(p.relative_to(ROOT)) for p in _port_sources()}
    assert {"jointpose_torch/train.py", "jointpose_torch/evaluate.py", "jointpose_torch/priors.py",
            "jointpose_torch/checkpoint.py", "jointpose_torch/metrics.py",
            "jointpose_torch/data/flic.py", "jointpose_torch/data/synthetic.py",
            "jointpose_torch/data/pipeline.py", "profile_tail_stages.py", "jointpose_torch/graphs.py",
            "jointpose_torch/serve.py", "jointpose_torch/resilience.py"} <= names


def test_synthetic_source_and_evaluation_need_cuda_unless_asked_for_cpu(monkeypatch, tmp_path):
    from jointpose_torch import evaluate
    from jointpose_torch.data.pipeline import make_dataset
    from jointpose_torch.train import fit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_dataset(cfg.data)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit(cfg, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--config", "tiny", "--checkpoint", str(tmp_path)])
    train, _ = make_dataset(cfg.data, "cpu")
    assert train.get_batch([0])["image"].device.type == "cpu"


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("tiny")
    state = init_state_dict(cfg, torch.Generator().manual_seed(0))
    for device in (None, "cuda", torch.device("cuda", 0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_predictor(cfg, state, device=device)
    assert resolve_device("cpu") == torch.device("cpu")
    coords, probs = build_predictor(cfg, state, device="cpu")(
        torch.zeros(1, *cfg.data.image_hw, 3, dtype=torch.uint8)
    )
    assert coords.shape == (1, 9, 2) and probs.device.type == "cpu"


def test_trainer_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("tiny")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            create_state(cfg, torch.Generator().manual_seed(0), device=device)
    state = create_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {p.device.type for p in state.model.parameters()} == {"cpu"}
    assert state.generator.device.type == "cpu" and state.step == 0


def test_server_needs_cuda_unless_asked_for_cpu(monkeypatch, tmp_path):
    from jointpose_torch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("tiny")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.PoseService(cfg, str(tmp_path), batch_size=2, device=device)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--config", "tiny", "--checkpoint", str(tmp_path)])
