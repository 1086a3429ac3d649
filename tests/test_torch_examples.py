"""The port's examples (``examples/torch_*.py``) run end to end on the CPU
when asked for it, print the line each one asserts, import neither JAX
nor the JAX package, and refuse to start without a GPU unless asked."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# example -> (small arguments, the line it prints after its own assert)
EXAMPLES = {
    "torch_quickstart.py": (["--n", "1500", "--pairs", "12", "--hub-k", "8"],
                            "distances are identical at C=1, at C=8 and through Hub^2"),
    "torch_open_loop_serving.py": (["--queries", "12", "--zipf-queries", "32"],
                                   "merged result maps identical across policies"),
    "torch_recovery.py": (["--n", "600", "--hub-k", "8"],
                          "recovered map identical to the uninterrupted run"),
    "torch_mutation.py": (["--n", "600", "--hub-k", "8"],
                          "the reopened graph answers as version 0 did"),
    "torch_xml_search.py": (["--n", "2000", "--queries", "6"],
                            "SLCANaive finds the same SLCAs"),
    "torch_serve_continuous_batching.py": (["--requests", "6"],
                                           "outputs identical across capacities"),
    "torch_train_lm.py": ([], "[train] finished at step 30 with 1 restart(s)"),
}

# runs an example as __main__, then reports which modules it loaded
_RUN = """
import json, runpy, sys
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"bad": bad}))
"""


def _run(name, args):
    # one OpenMP thread: the test workers share the box, and idle OpenMP
    # threads of concurrent examples spin against each other (six runs of
    # the deepseek example at once took 195 s with 8 threads, 5 s with 1)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", _RUN, str(ROOT / "examples" / name), *args],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_every_torch_example_is_covered():
    assert sorted(p.name for p in (ROOT / "examples").glob("torch_*.py")) == sorted(EXAMPLES)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu_when_asked(name):
    args, line = EXAMPLES[name]
    out = _run(name, ["--device", "cpu", *args])
    assert out.returncode == 0, out.stderr[-3000:]
    assert line in out.stdout, out.stdout[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"bad": []}


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b", "deepseek-v2-236b",
                                  "arctic-480b", "whisper-base"])
def test_serving_example_serves_every_family(arch):
    """The serving example on the reduced config of each family the dense
    default does not cover: all requests served at C=1 and C=8, the
    scheduler line printed; the recurrent and MoE families report their
    capacity-dependent tokens instead of asserting equality."""
    out = _run("torch_serve_continuous_batching.py",
               ["--device", "cpu", "--arch", arch, "--requests", "4"])
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("tokens for 4 requests") == 2, out.stdout[-3000:]
    assert "sjf statuses" in out.stdout
    shares = arch != "whisper-base"
    assert ("outputs differ across capacities" in out.stdout) == shares, out.stdout[-3000:]
    assert ("outputs identical across capacities" in out.stdout) != shares
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"bad": []}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_refuses_to_start_without_a_gpu(name):
    out = _run(name, EXAMPLES[name][0])
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr, out.stderr[-3000:]


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_names_no_jax_in_an_import(name):
    for text in (ROOT / "examples" / name).read_text().splitlines():
        words = text.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            assert words[1].split(".")[0] not in ("jax", "jaxlib", "repro"), text
