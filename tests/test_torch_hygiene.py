"""The PyTorch port stands alone: it loads no JAX and nothing of the JAX
package, its entry points never fall back to the CPU, it calls no library
attention, and ``chip_smoke.py`` refuses to run without a card."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import argmining, serve  # noqa: E402
from repro_torch.models import weights  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_every_module_loads_no_jax():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.serving.engine" in names and len(names) > 15
    assert {"repro_torch.core.pipeline", "repro_torch.core.stream",
            "repro_torch.core.filtering", "repro_torch.core.joins",
            "repro_torch.core.fault", "repro_torch.data.text",
            "repro_torch.models.svm", "repro_torch.kernels.pair_score",
            "repro_torch.configs.margot_svm",
            "repro_torch.launch.argmining",
            "repro_torch.configs.falcon_mamba_7b",
            "repro_torch.kernels.ssm_scan",
            "repro_torch.models.ssm",
            "repro_torch.core.service", "repro_torch.core.partitioner",
            "repro_torch.cluster.admission", "repro_torch.cluster.framing",
            "repro_torch.cluster.overload", "repro_torch.cluster.replica",
            "repro_torch.cluster.backends", "repro_torch.cluster.wire",
            "repro_torch.cluster.artifacts",
            "repro_torch.cluster.transport",
            "repro_torch.cluster.worker_main",
            "repro_torch.cluster.router",
            "repro_torch.cluster.timeseries", "repro_torch.cluster.slo",
            "repro_torch.cluster.dashboard",
            "repro_torch.cluster.autoscaler",
            "repro_torch.configs.starcoder2_3b"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') or m.startswith('jax'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+jax(lib)?\b", re.M),
    re.compile(r"^\s*from\s+repro(\.\w+)*\s+import\b", re.M),
    re.compile(r"^\s*import\s+repro(\.\w+)*\s*($|,|\bas\b)", re.M),
    re.compile(r"scaled_dot_product_attention|torch\.compile|"
               r"cpp_extension|flash_attn|xformers"),
]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_no_library_attention(path):
    text = path.read_text()
    if path.name == "chip_smoke.py":
        # the script times SDPA as the library yardstick, and only there
        checks = _FORBIDDEN[:3]
    else:
        checks = _FORBIDDEN
    for pat in checks:
        m = pat.search(text)
        assert m is None, f"{path.name}: {m.group(0)!r}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("internlm2-1.8b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.build_engine(reduce=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        weights.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        weights.params_from_numpy({}, cfg)
    params = weights.init_params(cfg, torch.Generator(), "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(params, cfg, ServeConfig(max_len=32, paged=True,
                                        block_size=8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduce", "--requests", "1"])
    for mode in ("batch", "stream"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            argmining.main([mode])


def build_module_report(**engine_kw):
    """A replica builder for the spawned-worker check below: it builds the
    port's LM backend (the whole engine stack loads in the worker), then
    serves the names of the JAX and ``repro`` modules the worker holds."""
    import sys as worker_sys

    from repro_torch.cluster.backends import build_engine
    from repro_torch.cluster.replica import FnBackend
    build_engine(**engine_kw)
    return FnBackend(lambda ps: [sorted(
        m for m in worker_sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "repro"))] * len(ps))


def test_spawned_process_replica_loads_no_jax():
    """A process replica of the port, spawned from this process (which
    holds JAX), builds a port engine and has no JAX in its interpreter."""
    import jax  # noqa: F401  the parent holds JAX: spawn, not fork

    from repro_torch.cluster import BackendSpec, Router
    r = Router()
    r.add_replica(spec=BackendSpec(f"{__name__}:build_module_report",
                                   dict(device="cpu", max_len=32)),
                  transport="process")
    req = r.submit("which modules?")
    assert r.wait(req, 60.0) == []
    r.stop()


def test_unknown_arch_is_named():
    """Every arch of the JAX registry is in the port's; an id neither
    knows raises, naming it."""
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import ARCH_IDS
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS)
    with pytest.raises(KeyError, match="whisper-large"):
        get_config("whisper-large")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "src/repro_torch" in out.stderr

