"""Import hygiene of the port: ``repro_torch``, ``chip_smoke.py`` and the
card tools under ``tools/`` import neither JAX nor the JAX package
``repro``, and the CUDA build is imported
only when a CUDA tensor reaches a kernel wrapper."""
import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)|"
    r"from\s+repro(\.|\s+import))", re.M)


def _port_sources():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"] + sorted((REPO / "tools").glob("*.py"))


def test_port_sources_never_import_jax_or_repro():
    offenders = [str(p.relative_to(REPO)) for p in _port_sources()
                 if FORBIDDEN.search(p.read_text())]
    assert not offenders, offenders
    assert len(_port_sources()) > 20


def test_forbidden_pattern_catches_what_it_must():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "import repro", "from repro.core import Runtime",
                 "from repro import kernels", "  import repro.core"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "import jaxlib_free"):
        assert not FORBIDDEN.search(line), line


def test_importing_the_port_and_chip_smoke_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.convert\n"
        "import repro_torch.distributed, repro_torch.kernels.ops\n"
        "import repro_torch.apps.jacobi3d, repro_torch.apps.dgemm\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.serve\n"
        "import repro_torch.launch.serve, repro_torch.kernels.flash_attention\n"
        "import repro_torch.models.ssm, repro_torch.kernels.ssd\n"
        "import repro_torch.models.encdec, repro_torch.data.pipeline\n"
        "import repro_torch.train, repro_torch.train.compression\n"
        "import repro_torch.launch.train, repro_torch.launch.elastic_train\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.kernels._build' not in sys.modules\n"
        "assert not hasattr(chip_smoke, 'Runtime')\n"
        "print('clean')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO / "src"), str(REPO)])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "clean" in out.stdout


def test_chip_smoke_fails_without_a_card():
    """Where torch sees no CUDA device the smoke test exits non-zero and
    prints no result line."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\n"
            "import chip_smoke\n"
            "sys.exit(chip_smoke.main())\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(REPO))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
