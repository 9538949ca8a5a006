"""The harness: files found by name, what a run refuses, and what a run
may not load."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import harness

ROOT = harness.ROOT


def _python(code: str, cwd: str, timeout: int = 600):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_a_config_a_cell_and_a_metric_are_added_as_files_only(tmp_path):
    """In a copy of the benchmark, new files and new entries in
    BENCHMARK.json add a configuration, a cell and a per-layer metric; no
    file of the copy is edited."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: (bench_dir / p).read_bytes()
              for p in (os.path.relpath(os.path.join(d, f), bench_dir)
                        for d, _, fs in os.walk(bench_dir) for f in fs)}
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(bench_dir / "configs" / "nhans-separator.json"))
    cfg["name"] = "nhans-separator-copy"
    (bench_dir / "configs" / "nhans-separator-copy.json").write_text(
        json.dumps(cfg))
    work = json.load(open(bench_dir / "workloads" /
                          "separator.train_sgd.json"))
    work.update(config="nhans-separator-copy", traffic="train_momentum")
    work["traffic_params"].update(alg="momentum", mom=0.9)
    (bench_dir / "workloads" / "separator-copy.train_momentum.json"
     ).write_text(json.dumps(work))
    (bench_dir / "metrics" / "steps_traced.py").write_text(textwrap.dedent(
        '''
        def read(facts, trace):
            return facts.get("traced_steps")
        '''))
    bench["configs"].append({"name": "nhans-separator-copy",
                             "source": "https://example.org/copy",
                             "file": "benchmark/configs/nhans-separator-copy.json",
                             "reduced": [], "why": "a copy"})
    bench["workloads"].append({"name": "separator-copy.train_momentum",
                               "config": "nhans-separator-copy",
                               "traffic": "train_momentum", "chips": 1,
                               "why": "a copy"})
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "train step",
                               "moves": "train_windows_per_s",
                               "workloads": ["separator-copy.train_momentum"]})
    bench["end_to_end"][2]["workloads"].append("separator-copy.train_momentum")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _python('''
        import json
        from benchmark import harness
        run = harness.open_run("separator-copy.train_momentum", 5, 1.0, True)
        assert harness.HERE.startswith(%r)
        run.facts["traced_steps"] = 3
        print(json.dumps({
            "config": run.config["name"],
            "alg": run.workload["traffic_params"]["alg"],
            "driver": harness.load_module("drivers", run.workload["driver"]).__name__,
            "e2e": [m["name"] for m in run.metrics("end_to_end")],
            "per_layer": harness.read_per_layer(run, None)}))
        ''' % str(tmp_path), str(tmp_path))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["config"] == "nhans-separator-copy"
    assert got["alg"] == "momentum"
    assert got["driver"].endswith("train")
    assert got["e2e"] == ["train_windows_per_s", "peak_mem_gib", "setup_s"]
    # the traced run finds the new metric; readers with nothing to read
    # are left out
    assert got["per_layer"] == {"steps_traced": {"value": 3.0,
                                                 "unit": "steps"}}
    for p, data in before.items():
        assert (bench_dir / p).read_bytes() == data, p


def test_without_a_card_a_run_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "denoiser.folder", "--seed", "4294967311",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 3 and out.stdout == ""


def test_in_a_directory_of_the_benchmark_alone_a_run_fails(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "separator.train_sgd", "--seed", "7", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""


def test_an_unknown_cell_is_refused():
    with pytest.raises(harness.BenchError):
        harness.open_run("no.such_cell", 1, 1.0, False)


@pytest.mark.parametrize("cell", ["denoiser.folder", "separator.train_adam"])
def test_set_up_loads_no_jax_and_no_jax_package(cell):
    """A driver's set-up at a narrow size, on the CPU, in a process of its
    own: no module whose whole top-level name is jax, jaxlib, flax,
    optax, orbax or nhans_tpu is loaded; the port, nhans_tpu_torch, is."""
    out = _python(f'''
        import sys, tempfile
        import torch
        torch.set_num_threads(2)
        from benchmark import harness
        from benchmark.tests import narrow
        with tempfile.TemporaryDirectory() as tmp:
            edit = (narrow.small_folder if {cell!r}.startswith("denoiser")
                    else narrow.small_train)
            run = narrow.run({cell!r}, tmp, workload_edits=edit,
                             max_samples=48000)
            driver = harness.load_module("drivers", run.workload["driver"])
            driver.window(driver.setup(run), 0.0)
        print(sorted({{m.split(".")[0] for m in sys.modules}}))
        print(harness.forbidden_modules())
        ''', ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, forbidden = out.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert "'nhans_tpu_torch'" in loaded and "'nhans_tpu'" not in loaded


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "nhans_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "nhans_tpu.config", sys)
    assert harness.forbidden_modules() == ["nhans_tpu.config"]


def test_the_reference_loads_nothing_of_the_program():
    out = _python('''
        import sys
        import benchmark.reference.model, benchmark.reference.serve
        import benchmark.reference.train, benchmark.reference.dsp
        print(sorted({m.split(".")[0] for m in sys.modules}))
        ''', ROOT)
    assert out.returncode == 0, out.stderr
    assert "nhans_tpu" not in out.stdout
