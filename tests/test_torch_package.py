"""Structure of the PyTorch port: no JAX inside it, sources packaged."""
import re
import tomllib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "gym_flock_tpu_torch"
_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|gym_flock_tpu)(\.|\s|$)", re.M)


def _port_files():
    return sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"]


@pytest.mark.parametrize("rel", _port_files())
def test_port_imports_no_jax(rel):
    """Neither the port nor chip_smoke.py imports jax or the JAX package."""
    text = (REPO / rel).read_text()
    assert not _JAX_IMPORT.search(text), rel


def test_kernel_sources_are_package_data():
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    data = cfg["tool"]["setuptools"]["package-data"]["gym_flock_tpu_torch"]
    assert "csrc/*.cu" in data
    assert any(PORT.glob("csrc/*.cu"))
    include = cfg["tool"]["setuptools"]["packages"]["find"]["include"]
    assert any(re.fullmatch(pat.replace("*", ".*"), "gym_flock_tpu_torch") for pat in include)
    assert "torch" in cfg["project"]["optional-dependencies"]
