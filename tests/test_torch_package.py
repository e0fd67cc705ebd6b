"""Structure of the PyTorch port: no JAX inside it, sources packaged."""
import re
import tomllib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "gym_flock_tpu_torch"
_JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|gym_flock_tpu)(\.|\s|$)", re.M)


TORCH_EXAMPLES = sorted(p.name for p in (REPO / "examples").glob("torch_*.py"))


def _port_files():
    return sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + [
        "chip_smoke.py", "tools/train_quality_torch.py", "tools/profile_coverage_train.py",
        "tools/profile_families.py", "tools/profile_facades.py",
        "tools/compare_legacy_parent.py"] + [
        f"examples/{name}" for name in TORCH_EXAMPLES]


@pytest.mark.parametrize("rel", _port_files())
def test_port_imports_no_jax(rel):
    """Neither the port, chip_smoke.py, the port's scripts under tools/ nor
    its example drivers import jax, flax, optax or the JAX package."""
    text = (REPO / rel).read_text()
    assert not _JAX_IMPORT.search(text), rel


def test_kernel_sources_are_package_data():
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    data = cfg["tool"]["setuptools"]["package-data"]["gym_flock_tpu_torch"]
    assert "csrc/*.cu" in data
    assert any(PORT.glob("csrc/*.cu"))
    # the port's copy of the VRP solver, compiled at first use
    assert "experts/vrp/*.cc" in data
    assert (PORT / "experts" / "vrp" / "vrp_solver.cc").is_file()
    include = cfg["tool"]["setuptools"]["packages"]["find"]["include"]
    assert any(re.fullmatch(pat.replace("*", ".*"), "gym_flock_tpu_torch") for pat in include)
    assert "torch" in cfg["project"]["optional-dependencies"]


AIRSIM_IDS = ("FlockingAirsimAccel-v0", "MappingAirsim-v0")


def test_registry_holds_every_jax_id_but_the_airsim_ones():
    """The 23 ids that need no AirSim client, each with the JAX package's
    ``max_episode_steps`` (the AirSim ids, registered too since they were
    ported, are held by ``test_registry_holds_every_jax_id``)."""
    import gym_flock_tpu as gft_jax
    import gym_flock_tpu_torch as gft

    want = {k: v.max_episode_steps for k, v in gft_jax.registry.items() if k not in AIRSIM_IDS}
    got = {k: v.max_episode_steps for k, v in gft.registry.items() if k not in AIRSIM_IDS}
    assert got == want
    assert len(got) == 23


def test_registry_holds_every_jax_id():
    """Every id of the JAX package, the two AirSim ones included, each with
    its ``max_episode_steps``; an AirSim id without a client raises the JAX
    package's ValueError."""
    import gym_flock_tpu as gft_jax
    import gym_flock_tpu_torch as gft

    want = {k: v.max_episode_steps for k, v in gft_jax.registry.items()}
    got = {k: v.max_episode_steps for k, v in gft.registry.items()}
    assert got == want
    assert len(got) == 25 and set(AIRSIM_IDS) <= set(got)
    for env_id in AIRSIM_IDS:
        with pytest.raises(ValueError, match="requires an AirSim-compatible client"):
            gft.make(env_id)
        with pytest.raises(ValueError, match="requires an AirSim-compatible client"):
            gft_jax.make(env_id)


def _flags(path: Path):
    """The option strings of every ``add_argument`` call of a script."""
    import ast

    return {arg.value for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
            for arg in node.args if isinstance(arg, ast.Constant)}


def test_eight_torch_examples():
    assert len(TORCH_EXAMPLES) == 8


@pytest.mark.parametrize("name", TORCH_EXAMPLES)
def test_torch_example_takes_its_jax_twins_flags(name):
    """Each example driver of the port beside its JAX twin takes every flag
    of the twin; the GPU is its default, ``--cpu`` the host."""
    twin = REPO / "examples" / name[len("torch_"):]
    want = _flags(twin)
    assert want and want <= _flags(REPO / "examples" / name)
    if "--cpu" in want:
        assert '"cpu" if args.cpu else "cuda"' in (REPO / "examples" / name).read_text()


def _run_example(*argv):
    import subprocess
    import sys

    return subprocess.run([sys.executable, str(REPO / "examples" / argv[0]), *argv[1:]],
                          capture_output=True, text=True, timeout=300, cwd=str(REPO))


def test_torch_run_shepherding_smoke():
    """examples/torch_run_shepherding.py (reference shepherding/test.py)
    runs an episode loop end to end on the host."""
    out = _run_example("torch_run_shepherding.py", "--cpu", "-N", "1", "--steps", "3")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip()


def test_torch_run_coverage_strict_expert_smoke():
    """examples/torch_run_coverage.py --strict-expert completes an episode
    with its restart-on-AssertionError loop (reference test.py:53-59)."""
    out = _run_example("torch_run_coverage.py", "-e", "--strict-expert", "-n", "1", "--cpu")
    assert out.returncode == 0, out.stderr[-800:]
    assert "Expert" in out.stdout
    assert "Reward over 1 episodes" in out.stdout
