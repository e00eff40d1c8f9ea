"""The port's FASTQ extraction stage (t1k_tpu_torch.core.extractor and its
CLI) against the JAX package's native route, byte for byte.  The gpu
route runs here on the CPU through the kernels' plain versions
(--device cpu)."""

import os
import subprocess
import sys

import pytest
import torch

from t1k_tpu.cli.extract import main as host_main
from t1k_tpu_torch.cli.extract import main as port_main
from t1k_tpu_torch.core.extractor import DEVICE_MIN_READS, lazy_device_screen
from t1k_tpu_torch.device import NoCardError
from t1k_tpu_torch.utils.observability import metrics

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DATA_DIR = os.path.join(HERE, "data")
PANEL = os.path.join(DATA_DIR, "multigene_rna.fa")

CASES = {
    "multigene": ["-1", os.path.join(DATA_DIR, "multigene_1.fq"),
                  "-2", os.path.join(DATA_DIR, "multigene_2.fq")],
    "barcode": ["-1", os.path.join(DATA_DIR, "extract_1.fq"),
                "-2", os.path.join(DATA_DIR, "extract_2.fq"),
                "--barcode", os.path.join(DATA_DIR, "extract_bc.fq"),
                "--barcodeWhitelist",
                os.path.join(DATA_DIR, "bc_whitelist.txt")],
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run as many small tensor operations: on one
    thread, so that the suite's test processes running side by side do
    not wait on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", sorted(CASES))
def test_gpu_route_matches_native_byte_for_byte(tmp_path, case):
    args = ["-f", PANEL, *CASES[case]]
    native = str(tmp_path / "native")
    port = str(tmp_path / "port")
    assert host_main([*args, "-o", native, "--backend", "native"]) == 0
    assert port_main([*args, "-o", port, "--backend", "gpu",
                      "--device", "cpu"]) == 0
    st = metrics().stages["extraction_screen"]
    assert st["device_screened_reads"] > 0
    if case == "barcode":  # off-panel reads: the device decides them
        assert st["device_decided_reads"] > 0
    else:  # 120 near-identical alleles: every chunk overflows the hit cap
        assert st["device_decided_reads"] == 0
    suffixes = ["_1.fq", "_2.fq"] + (["_bc.fa"] if case == "barcode" else [])
    for suffix in suffixes:
        assert _read(port + suffix) == _read(native + suffix), suffix
    assert st["candidate_count"] == _read(port + "_1.fq").count(b"\n@") + 1


def test_extraction_imports_no_jax(tmp_path):
    out = str(tmp_path / "sub")
    code = (
        "import sys\n"
        "from t1k_tpu_torch.cli.extract import main\n"
        f"main({['-f', PANEL, *CASES['multigene'], '-o', out, '--backend', 'gpu', '--device', 'cpu']!r})\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 't1k_tpu' or m.startswith('t1k_tpu.')\n"
        "               for m in sys.modules), 'the JAX package was imported'\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    native = str(tmp_path / "native")
    assert host_main(["-f", PANEL, *CASES["multigene"], "-o", native,
                      "--backend", "native"]) == 0
    assert _read(out + "_1.fq") == _read(native + "_1.fq")


def test_gpu_route_without_cuda_raises(tmp_path, monkeypatch):
    """--backend gpu on --device cuda (the default) never runs elsewhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["-f", PANEL, *CASES["multigene"], "-o",
                   str(tmp_path / "x"), "--backend", "gpu"])


def test_lazy_gate_counts_streamed_reads(monkeypatch):
    """auto engages the device only past T1K_SCREEN_DEVICE_MIN_READS
    streamed reads; without a card it raises at once unless the device is
    the CPU; gpu engages at once; native never."""
    for var in ("T1K_BACKEND", "T1K_GPU_PRESENT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("T1K_SCREEN_DEVICE_MIN_READS", "100")
    built = []

    def build():
        built.append(1)
        return "screen"

    monkeypatch.setenv("T1K_GPU_PRESENT", "1")
    get = lazy_device_screen("auto", build)
    assert get(60) is None and get(60) is None  # 0, then 60 streamed
    assert get(60) == "screen" and get(10) == "screen"
    assert built == [1]
    monkeypatch.setenv("T1K_GPU_PRESENT", "0")
    with pytest.raises(NoCardError, match="--device cpu"):
        lazy_device_screen("auto", build)
    get = lazy_device_screen("auto", build, device="cpu")
    assert [get(60), get(60), get(1)] == [None, None, "screen"]
    assert built == [1, 1]
    assert lazy_device_screen("gpu", build)(1) == "screen"
    get = lazy_device_screen("native", build)
    assert [get(10 ** 7), get(10 ** 7)] == [None, None]
    assert built == [1, 1, 1]
    monkeypatch.delenv("T1K_SCREEN_DEVICE_MIN_READS")  # the default gate
    monkeypatch.setenv("T1K_GPU_PRESENT", "1")
    get = lazy_device_screen("auto", build)
    assert get(DEVICE_MIN_READS) is None and built == [1, 1, 1]
    assert get(1) == "screen" and built == [1, 1, 1, 1]


def test_auto_without_a_card_exits_and_explicit_routes_run(
        tmp_path, monkeypatch, capsys):
    """No card: --backend auto stops with the error naming --backend
    native and --device cpu; both of those give the native route's
    bytes."""
    for var in ("T1K_BACKEND", "T1K_GPU_PRESENT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["-f", PANEL, *CASES["barcode"]]
    with pytest.raises(SystemExit) as exc:
        port_main([*args, "-o", str(tmp_path / "auto")])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--backend native" in err and "--device cpu" in err
    native = str(tmp_path / "native")
    assert host_main([*args, "-o", native, "--backend", "native"]) == 0
    for name, flags in (("cpu", ["--device", "cpu"]),
                        ("host", ["--backend", "native"])):
        out = str(tmp_path / name)
        assert port_main([*args, "-o", out, *flags]) == 0
        for suffix in ("_1.fq", "_2.fq", "_bc.fa"):
            assert _read(out + suffix) == _read(native + suffix), suffix
