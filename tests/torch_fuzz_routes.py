"""Routes of the port's fuzz tests (tests/test_torch_fuzz_*.py load this
file by path; it holds no test).

`triangle` runs a scripts/fuzz_cases.py case on the JAX package's native
route (t1k_tpu.<module>.main under T1K_BACKEND=native), the port's native
route (--backend native --emBackend native) and the port's gpu route on
the CPU (--backend gpu --emBackend gpu --device cpu: the kernels' plain
versions, with the case's port-only flags; a plate's second pass as
--cohortEm), in this process, and holds every output of both port routes
to the JAX route's by the fuzzers' rules (fuzz_cases.verdict)."""

import contextlib
import importlib
import importlib.util
import io
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
NATIVE = ["--backend", "native", "--emBackend", "native"]
# the JAX package's native route: the flags each module takes
JAX_FLAGS = {"cli.run": NATIVE, "cli.genotype": NATIVE,
             "cli.analyze": ["--backend", "native"],
             "cli.extract": ["--backend", "native"], "cli.bamextract": [],
             "tools.smartseq": []}


def load(name, path):
    """The module at `path`, as `name` in sys.modules (its dataclasses
    look their module up there)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


fc = load("fuzz_cases", os.path.join(REPO, "scripts", "fuzz_cases.py"))


def jax_main(module):
    return importlib.import_module(f"t1k_tpu.{module}").main


def triangle(case, monkeypatch):
    """Every run of `case` exits 0 on the three routes, the JAX route
    writes outputs, and each port route's outputs equal them."""
    routes = {
        "jax": (lambda out: lambda r: [fc.render(a, out) for a in r.argv]
                + JAX_FLAGS[r.module], jax_main),
        "native": (lambda out: lambda r: fc.route_argv(r, "native", out,
                                                       "cpu"), fc.port_main),
        "cpu": (lambda out: lambda r: fc.route_argv(r, "gpu", out, "cpu"),
                fc.port_main)}
    done = {}
    for name, (argv_of, main_of) in routes.items():
        out = os.path.join(case.dir, name)
        with monkeypatch.context() as m:
            if name == "jax":
                m.setenv("T1K_BACKEND", "native")
            else:
                m.delenv("T1K_BACKEND", raising=False)
            runs = fc.run_case(case, out, argv_of(out), main_of)
        assert [r["rc"] for r in runs] == [0] * len(case.runs), \
            (name, case.flags, [r["error"] for r in runs])
        done[name] = (out, runs)
    sizes = [os.path.getsize(p) for p in fc._files(done["jax"][0]).values()]
    assert sum(sizes) > 0, case.flags
    for name in ("native", "cpu"):
        got = fc.verdict(case, *done["jax"], *done[name])
        assert got == ("ok", None), (name, case.flags, got)


def stdout_of(main, argv):
    """`main(argv)` in this process: its exit code (1 where it raises)
    and standard output, as subprocess.run's result holds them."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    except Exception:
        rc = 1
    return types.SimpleNamespace(returncode=rc or 0, stdout=buf.getvalue(),
                                 stderr="")


class Pairs:
    """A host-only fuzzer's runs, the JAX package in its reference's
    place (`ref`) and the port as its own (`mine`), paired in call order:
    it runs its own only after a reference run that exited 0."""

    def __init__(self):
        self.pairs, self._ref = [], None

    def ref(self, got):
        self._ref = got
        return got

    def mine(self, got):
        self.pairs.append((self._ref, got))
        return got

    def check(self, at_least: int):
        """Each pair's exit codes and standard outputs equal, byte for
        byte, over at least `at_least` pairs with output."""
        assert sum(1 for a, _ in self.pairs if a.stdout) >= at_least
        for a, b in self.pairs:
            assert (a.returncode, a.stdout) == (b.returncode, b.stdout)
