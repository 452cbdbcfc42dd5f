"""The port's shared CLI plumbing (``jointpose_torch.cli``, counterpart of
``jointpose/cli.py``): the kernels' build cache that
``enable_compilation_cache`` stands for, chosen by ``JOINTPOSE_CACHE_DIR``
and ``JOINTPOSE_NO_COMPILE_CACHE`` (checked by the path chosen: there is
no ``nvcc`` here), and ``--device`` on every CLI."""

import argparse
import os
from pathlib import Path

import pytest
import torch

from jointpose_torch import _build, cli, evaluate, predict, quantize, serve, train

ROOT = Path(__file__).resolve().parent.parent


def test_default_build_dir_is_the_repositorys(monkeypatch):
    monkeypatch.delenv("JOINTPOSE_CACHE_DIR", raising=False)
    monkeypatch.delenv("JOINTPOSE_NO_COMPILE_CACHE", raising=False)
    assert _build.build_dir() == ROOT / "build" / "jointpose_torch"
    assert _build._lib_path("shear_warp").parent == ROOT / "build" / "jointpose_torch"


def test_cache_dir_moves_the_build(monkeypatch, tmp_path):
    monkeypatch.delenv("JOINTPOSE_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JOINTPOSE_CACHE_DIR", str(tmp_path))
    assert cli.enable_compilation_cache() == str(tmp_path / "jointpose_torch")
    assert (tmp_path / "jointpose_torch").is_dir()
    lib = _build._lib_path("mrf_epilogue")
    assert lib.parent == tmp_path / "jointpose_torch" and lib.name.startswith("mrf_epilogue-")


def test_no_compile_cache_builds_into_a_fresh_directory(monkeypatch, tmp_path):
    monkeypatch.setenv("JOINTPOSE_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("JOINTPOSE_NO_COMPILE_CACHE", "1")
    _build._fresh_dir.cache_clear()
    assert cli.enable_compilation_cache() is None
    fresh = _build.build_dir()
    assert fresh.is_dir() and not list(fresh.iterdir())
    assert tmp_path not in fresh.parents and fresh != _build.DEFAULT_BUILD_DIR
    assert _build.build_dir() == fresh  # one directory per process
    assert _build._lib_path("fft_conv_tail").parent == fresh
    fresh.rmdir()
    _build._fresh_dir.cache_clear()


def test_device_flag_keeps_its_meaning_and_help():
    parser = argparse.ArgumentParser()
    cli.add_device_flag(parser)
    assert parser.parse_args([]).device is None
    assert parser.parse_args(["--device", "cpu"]).device == "cpu"
    assert parser._option_string_actions["--device"].help == cli.DEVICE_HELP
    assert cli.apply_device("cpu") == torch.device("cpu")


CLIS = {
    "train": (train.main, ["--workdir", "W"]),
    "evaluate": (evaluate.main, ["--checkpoint", "C"]),
    "predict": (predict.main, ["--checkpoint", "C", "--workdir", "W"]),
    "quantize": (quantize.main, ["--checkpoint", "C", "--out", "O"]),
    "serve": (serve.main, ["--checkpoint", "C"]),
}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_each_cli_refuses_cuda_without_it_unless_asked_for_the_cpu(name, monkeypatch, tmp_path):
    main, args = CLIS[name]
    args = [str(tmp_path / a) if a in "CWO" else a for a in args]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA.*device='cpu'"):
        main(["--config", "no-such-preset", *args])
    # With --device cpu the CLI goes on, and fails only at the unknown preset.
    with pytest.raises(Exception) as raised:
        main(["--config", "no-such-preset", *args, "--device", "cpu"])
    assert "CUDA" not in str(raised.value) and "no-such-preset" in str(raised.value)
    assert not os.path.exists(tmp_path / "W")
