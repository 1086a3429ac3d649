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
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
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
