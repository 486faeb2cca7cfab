"""Package boundary of the port: ``repro_torch`` imports neither JAX nor
the JAX package, its entry points refuse to run on a missing GPU unless
the CPU is asked for, and its qwen2-0.5b config equals the reference's."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import ASSIGNED                  # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch.configs.registry import get_config          # noqa: E402
from repro_torch.launch import serve as serve_cli            # noqa: E402
from repro_torch.models.registry import build_model          # noqa: E402
from repro_torch.runtime.serving import ServingEngine        # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def test_import_loads_no_jax_and_no_reference_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(len([n for n in sys.modules if n.startswith("repro_torch")]))
        sys.exit("loaded: " + ", ".join(bad) if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr + res.stdout
    assert int(res.stdout.strip()) >= 20          # every submodule loaded


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    cpu_api = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cpu_api, 2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--requests", "1", "--batch", "1"])


def test_wa_engine_defaults_to_cuda(no_cuda):
    """The WA domains are CUDA streams: without a GPU the default device
    raises, and no path falls back to the CPU."""
    from repro_torch.core.wa import WADisaggregated
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WADisaggregated(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--requests", "1", "--batch", "2", "--backend",
                        "wa", "--overlap", "2"])


def test_engine_refuses_devices_it_cannot_serve_on():
    api = build_model(get_config("qwen2-0.5b").reduced(), device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        ServingEngine(api, 2, 8, device=torch.device("meta"))


@pytest.mark.parametrize("reduced", [False, True])
def test_qwen2_config_equals_reference_field_by_field(reduced):
    ref = ASSIGNED["qwen2-0.5b"]
    port = get_config("qwen2-0.5b")
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    ref_fields = [f.name for f in dataclasses.fields(ref)]
    port_fields = [f.name for f in dataclasses.fields(port)]
    assert port_fields == ref_fields
    for name in ref_fields:
        assert getattr(port, name) == getattr(ref, name), name


def test_cli_serves_reduced_on_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--requests", "3", "--batch", "2",
                    "--prompt-len", "6", "--max-new", "4",
                    "--arrival-every", "2", "--block-size", "2",
                    "--kv-bucket-chunk", "8", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "'completed': 3" in out and "serve_prefill_chunk" in out


def test_cli_serves_wa_overlap_on_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--requests", "5", "--batch", "4",
                    "--prompt-len", "6", "--max-new", "5",
                    "--arrival-every", "2", "--block-size", "4",
                    "--kv-bucket-chunk", "16", "--prefill-chunk", "3",
                    "--backend", "wa", "--overlap", "2"])
    out = capsys.readouterr().out
    assert "'completed': 5" in out and "'backend': 'wa'" in out
    assert "wa routing:" in out and "wa overlap: depth=2" in out
    assert "serve_wa_prefill_chunk" in out and "'overlap': 2" in out
    assert "'compiles': 2" not in out
