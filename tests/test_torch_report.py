"""The port's report (``repro_torch.launch.report``) against the JAX
package's (``repro.launch.report``).

The hot-path tables: the committed ``BENCH_quegel.json`` byte for byte,
and synthetic JSONs in its schema, built from a numpy seed, that together
reach every branch of ``bench_tables``.  The dry-run tables: one list of
cells given to both packages, each under its own mesh names, and the JSON
that the port's own dry runs write.  The text differs from JAX's by three
words only: the mesh columns (``16x16 | 2x16x16`` and ``single-pod
16x16`` read ``32x8 | 2x32x8`` and ``single-pod 32x8``), the compute-bound
decode lever ("MXU-shaped" reads "tensor-core-shaped"), and the hot-path
header's ``jax`` where ``meta`` carries ``torch``."""
import copy
import dataclasses as dc
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import report as JR

from repro_torch.configs import SHAPES, get_arch, reduced
from repro_torch.launch import dryrun as DR
from repro_torch.launch import dryrun_quegel as DQ
from repro_torch.launch import report as TR
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import MESH_NAMES, make_mesh
from repro_torch.models import common as TC

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "BENCH_quegel.json"
# lines that ``--bench BENCH_quegel.json`` prints; chip_smoke.py's phase 14c
# reads this count from here and holds the card machine's render to it
BENCH_QUEGEL_LINES = 182

J_MESH = {MESH_NAMES[False]: "pod16x16", MESH_NAMES[True]: "pod2x16x16"}
SUBST = (("| 16x16 | 2x16x16 |", "| 32x8 | 2x32x8 |"),
         ("single-pod 16x16", "single-pod 32x8"),
         ("(MXU-shaped)", "(tensor-core-shaped)"))


def _as_port(text: str) -> str:
    """JAX's dry-run text with the port's three words in place of its own."""
    for old, new in SUBST:
        text = text.replace(old, new)
    return text


def _jax_cells(cells):
    return [dict(c, mesh=J_MESH.get(c["mesh"], c["mesh"])) for c in cells]


# ------------------------------------------------------------ hot path
def test_committed_bench_prints_what_jax_prints(capsys):
    assert TR.main(["--bench", str(BENCH)]) == 0
    out = capsys.readouterr().out
    assert out == JR.bench_tables(str(BENCH)) + "\n"
    assert len(out.splitlines()) == BENCH_QUEGEL_LINES


def _bench(seed: int) -> dict:
    """A JSON in BENCH_quegel.json's schema with every section and key the
    report reads, its numbers drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    sec = lambda: float(10 ** rng.uniform(-4, 1))    # both of fmt_s's branches
    rate = lambda: float(10 ** rng.uniform(0, 4))
    num = lambda hi=500: int(rng.integers(1, hi))

    def cell():
        r = num()
        return dict(wall_s=sec(), super_rounds=r, barriers=r, super_rounds_per_sec=rate(),
                    queries_per_sec=rate(), p50_query_latency_s=sec(),
                    p95_query_latency_s=sec(), supersteps_total=num(5000))

    def curve_point():
        return dict(achieved_qps=rate(), busy_qps=rate(), lat_p50=rate(), lat_p95=rate(),
                    lat_p99=rate(), max_backlog=num())

    def staged():
        return dict(light_p95_s=sec(), light_p95_rounds=rate(), heavy_p95_rounds=rate(),
                    preemptions=num(), max_inflight=num(16))

    return dict(
        meta=dict(jax="0.4.37", backend="cpu", quick=False, platform="Linux-x86_64",
                  python="3.12.0", cpus=num(64), timestamp="2026-10-17T00:00:00+00:00",
                  env="cpus=8 tcmalloc=absent", git_sha="0123456789abcdef0123"),
        workloads={"ppsp": {"coo": {"C1": cell(), "C8": cell()},
                            "cuda": {"C8_small": cell()}},
                   "hub2": {"coo": {"C8": cell()}}},
        ab=dict(workload="ppsp_bfs_coo_C8", legacy=cell(), fused=cell(),
                speedup_super_rounds_per_sec=rate(), speedup_queries_per_sec=rate()),
        sparsity=dict(
            propagation={be: dict(dense_s=sec(), gated_s=sec(), speedup=rate())
                         for be in ("coo", "blocks_ref")},
            rounds={f"k{k}": dict(barriers=num(), super_rounds_per_sec=rate(),
                                  queries_per_sec=rate()) for k in (1, 4, 8)},
            barrier_reduction_k8=rate()),
        mutation=dict(
            n=num(10 ** 6), edges=num(10 ** 7), k=num(64),
            sizes={lab: dict(delta_rows=num(), frac=float(rng.uniform()), inc_ms=rate(),
                             rebuild_ms=rate(), speedup=rate(), affected_hubs=num(64))
                   for lab in ("1e-4", "1e-3", "1e-2")},
            crossover_frac=float(rng.uniform()),
            serving_ab=dict(first_answer_speedup=rate(), **{
                m: dict(mutate_to_first_answer_ms=rate(), old_answer_ms=rate(),
                        apply_ms=rate(), compiles=num(12))
                for m in ("constant", "arg_carried", "warmup")})),
        serving=dict(
            meta=dict(capacity=8, n_heavy=num(16), n_light=num(64), quick=False),
            schedulers={s: dict(wall_s=sec(), queries_per_sec=rate(), light_p50_s=sec(),
                                light_p95_s=sec(), heavy_p95_s=sec(),
                                light_p95_rounds=rate(), qwait_p95_s=sec(),
                                service_p95_s=sec(), mean_occupancy=float(rng.uniform(0, 8)))
                        for s in ("fifo", "priority", "sjf", "deadline")},
            light_p95_speedup={s: rate() for s in ("priority", "sjf", "deadline")},
            staged_preemption=dict(sjf=staged(), sjf_preemptive=staged(),
                                   light_p95_rounds_speedup=rate(),
                                   light_p95_speedup=rate()),
            cache=dict(on=dict(cache_hits=num(), rounds=num()), off=dict(rounds=num()),
                       speedup=rate())),
        sharded=dict(
            meta=dict(devices=8, quick=False),
            ppsp=dict(single=cell(),
                      dst={"w2": dict(super_rounds_per_sec=rate(), queries_per_sec=rate(),
                                      collective=dict(round_total_bytes=float(2 ** 23))),
                           "w8": dict(super_rounds_per_sec=rate(), queries_per_sec=rate())},
                      src={"w4": dict(super_rounds_per_sec=rate(), queries_per_sec=rate(),
                                      collective=dict(round_total_bytes=float(3000)))}),
            reach=dict(single=cell(),
                       dst={"w8": dict(super_rounds_per_sec=rate(), queries_per_sec=rate(),
                                       collective=dict(round_total_bytes=float(100)))})),
        recovery=dict(
            meta=dict(quick=False),
            restore=dict(cold_start_s=sec(), index_rounds_cold=num(), restore_s=sec(),
                         store_bytes=float(num(10 ** 9)), speedup=rate()),
            journal={t: dict(wall_s=sec(), overhead_pct=rate(),
                             journal_bytes=float(num(10 ** 7)), journal_records=num(),
                             snapshots=num()) for t in ("off", "wal", "snap8", "snap1")},
            mttr=dict(crash_round=num(), replay_s=sec(), replayed_done=num(),
                      resumed_from_snapshot=num(), resubmitted=num(), mttr_s=sec(),
                      rounds_to_first_retirement=num())),
        loadgen=dict(
            meta=dict(graph="barabasi_albert(4096, 3)", capacity=8, quick=False),
            curves={"fifo": {"R1": dict(curve={"2": curve_point(), "0.5": curve_point(),
                                               "1": curve_point()}, knee=1.5)},
                    "sjf": {"R2": dict(curve={"4": curve_point()}, knee=3.0)}},
            arrivals={"poisson": dict(lat_p99=rate()), "mmpp": dict(lat_p99=rate())},
            routing=dict(meta=dict(replicas=4, cache_size=16, n_keys=64),
                         **{p: dict(hit_rate=float(rng.uniform()), balance=rate(),
                                    spills=num(), boot_s=sec(), results_match_single=True)
                            for p in ("affine", "rr", "p2c")},
                         affine_vs_rr_hit_ratio=rate()),
            wall=dict(offered_qps=rate(), achieved_qps=rate(), lat_p95=sec())))


def _drop(d: dict, *path):
    for key in path[:-1]:
        d = d[key]
    del d[path[-1]]


def _no_provenance(b):
    for k in ("platform", "cpus", "git_sha", "timestamp", "env"):
        _drop(b, "meta", k)
    _drop(b, "ab")


def _quick(b):
    b["meta"]["quick"] = True
    for k in ("cpus", "git_sha", "timestamp", "env"):
        _drop(b, "meta", k)


def _sparsity_bare(b):
    _drop(b, "sparsity", "rounds")
    _drop(b, "sparsity", "barrier_reduction_k8")


def _mutation_partial(b):
    mu = b["mutation"]
    mu["crossover_frac"] = None
    mu["serving_ab"]["first_answer_speedup"] = None
    for k in ("n", "edges", "k"):
        _drop(mu, k)
    _drop(mu, "serving_ab", "arg_carried")


def _serving_partial(b):
    sv = b["serving"]
    sv["meta"]["quick"] = True
    sv["schedulers"]["sjf"].update(qwait_p95_s=None, service_p95_s=None)
    _drop(sv, "schedulers", "fifo", "light_p95_rounds")
    _drop(sv, "staged_preemption", "sjf")
    sv["light_p95_speedup"] = {}


def _serving_bare(b):
    _drop(b, "serving", "staged_preemption")
    _drop(b, "serving", "cache")
    _drop(b, "serving", "meta")


def _sharded_without_single(b):
    b["sharded"]["meta"]["quick"] = True
    _drop(b, "sharded", "ppsp", "single")
    _drop(b, "sharded", "reach", "single")


def _recovery_only(part):
    def f(b):
        for other in {"restore", "journal", "mttr"} - {part}:
            _drop(b, "recovery", other)
        b["recovery"]["meta"]["quick"] = part == "journal"
    return f


def _journal_partial(b):
    _recovery_only("journal")(b)
    _drop(b, "recovery", "journal", "wal")


def _routing_mismatch(b):
    lg = b["loadgen"]
    lg["meta"]["quick"] = True
    lg["routing"]["rr"]["results_match_single"] = False
    _drop(lg, "routing", "affine")
    _drop(lg, "routing", "affine_vs_rr_hit_ratio")
    for k in ("hit_rate", "balance", "spills", "boot_s"):
        _drop(lg, "routing", "p2c", k)


def _loadgen_bare(b):
    for k in ("arrivals", "routing", "wall", "meta"):
        _drop(b, "loadgen", k)


def _workloads_only(b):
    for k in ("ab", "sparsity", "mutation", "serving", "sharded", "recovery", "loadgen"):
        _drop(b, k)


CASES = {
    "full": lambda b: None,
    "no_provenance_no_ab": _no_provenance,
    "quick_platform_only": _quick,
    "sparsity_without_rounds": _sparsity_bare,
    "mutation_partial": _mutation_partial,
    "serving_partial": _serving_partial,
    "serving_bare": _serving_bare,
    "sharded_without_single": _sharded_without_single,
    "recovery_restore_only": _recovery_only("restore"),
    "recovery_journal_only": _journal_partial,
    "recovery_mttr_only": _recovery_only("mttr"),
    "loadgen_routing_mismatch": _routing_mismatch,
    "loadgen_curves_only": _loadgen_bare,
    "workloads_only": _workloads_only,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_synthetic_bench_prints_what_jax_prints(case, tmp_path):
    bench = _bench(seed=sorted(CASES).index(case))
    CASES[case](bench)
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(bench))
    got, want = TR.bench_tables(str(path)), JR.bench_tables(str(path))
    assert got == want
    assert "## Engine hot path (" in got


def test_torch_meta_names_torch_in_the_header(tmp_path, capsys):
    """A JSON the port writes: ``meta`` carries ``torch`` where JAX's carries
    ``jax``; the one header word differs, nothing else."""
    bench = _bench(seed=99)
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    jpath.write_text(json.dumps(bench))
    bench = copy.deepcopy(bench)
    bench["meta"]["torch"] = bench["meta"].pop("jax")
    bench["meta"]["backend"] = "cuda"
    tpath.write_text(json.dumps(bench))
    want = JR.bench_tables(str(jpath)).replace("(cpu, jax 0.4.37)", "(cuda, torch 0.4.37)")
    assert want.count("(cuda, torch 0.4.37)") == 1
    assert TR.main(["--bench", str(tpath)]) == 0
    assert capsys.readouterr().out == want + "\n"


# ------------------------------------------------------------ dry runs
SP, MP = MESH_NAMES[False], MESH_NAMES[True]


def _cells(seed: int) -> list:
    """Dry-run cells under the port's mesh names: compiled, skipped and
    FAILED; each bottleneck at a train-like and a decode shape; a Quegel
    cell without a roofline on both meshes; an sp cell without its mp twin
    and an mp cell without its sp cell; and the keys the report never
    reads (traced_on, full_count, batch_axes, compile_s)."""
    rng = np.random.default_rng(seed)
    sec = lambda: float(10 ** rng.uniform(-4, 1))
    gib = lambda: float(rng.uniform(0.1, 70) * 2 ** 30)
    extra = dict(traced_on=dict(counts="fake-traced, not measured", world=256),
                 full_count=dict(flops=1.0, bytes=2.0, coll=3.0), batch_axes=["data"],
                 compile_s=12.5)

    def compiled(arch, shape, mesh, bottleneck=None):
        c = dict(arch=arch, shape=shape, mesh=mesh, status="compiled",
                 n_micro=int(rng.integers(1, 9)), memory=dict(temp_bytes=gib(), arg_bytes=gib()),
                 **extra)
        if bottleneck:
            c["roofline"] = dict(t_compute=sec(), t_memory=sec(), t_collective=sec(),
                                 bottleneck=bottleneck, useful_ratio=float(rng.uniform()),
                                 roofline_fraction=float(rng.uniform()),
                                 coll_bytes=float(10 ** rng.uniform(3, 11)))
        return c

    return [
        compiled("tinyllama-1.1b", "train_4k", SP, "compute"),
        compiled("tinyllama-1.1b", "train_4k", MP),
        compiled("tinyllama-1.1b", "decode_32k", SP, "compute"),
        compiled("tinyllama-1.1b", "decode_32k", MP),
        compiled("gemma2-9b", "prefill_32k", SP, "memory"),       # no mp twin
        compiled("gemma2-9b", "long_500k", SP, "memory"),
        compiled("arctic-480b", "train_4k", SP, "collective"),
        compiled("arctic-480b", "decode_32k", SP, "collective"),
        compiled("arctic-480b", "decode_32k", MP),
        compiled("mamba2-780m", "train_4k", MP),                  # no sp cell
        dict(arch="whisper-base", shape="long_500k", mesh=SP, status="skipped",
             reason="full attention at 500k"),
        dict(arch="whisper-base", shape="long_500k", mesh=MP, status="skipped",
             reason="full attention at 500k"),
        dict(arch="deepseek-v2-236b", shape="train_4k", mesh=SP, status="FAILED",
             error="RuntimeError: out of memory"),
        compiled("quegel-bibfs", "C64_V67108864_E2147483648", SP),
        compiled("quegel-bibfs", "C64_V67108864_E2147483648", MP),
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_dryrun_table_equals_jax(seed):
    cells = _cells(seed)
    got = TR.dryrun_table(cells)
    assert got == _as_port(JR.dryrun_table(_jax_cells(cells)))
    assert got.startswith("| arch | shape | 32x8 | 2x32x8 |")
    assert "| mamba2-780m | train_4k | — | compiled |" in got
    assert "quegel" not in got


@pytest.mark.parametrize("seed", [0, 1])
def test_roofline_table_equals_jax(seed):
    cells = _cells(seed)
    got = TR.roofline_table(cells)
    assert got == _as_port(JR.roofline_table(_jax_cells(cells)))
    assert got.count("(tensor-core-shaped)") == 1 and len(got.splitlines()) == 2 + 6


def _jax_main(monkeypatch, capsys, d) -> str:
    monkeypatch.setattr(sys, "argv", ["report", "--dir", str(d)])
    JR.main()
    return capsys.readouterr().out


def _write_cells(d: Path, cells) -> None:
    d.mkdir(parents=True, exist_ok=True)
    for i, c in enumerate(cells):
        (d / f"{i:02d}_{c['arch']}_{c['shape']}_{c['mesh']}.json").write_text(json.dumps(c))


@pytest.mark.parametrize("seed", [0, 1])
def test_main_dir_equals_jax(seed, tmp_path, monkeypatch, capsys):
    cells = _cells(seed)
    _write_cells(tmp_path / "port", cells)
    _write_cells(tmp_path / "jax", _jax_cells(cells))
    assert TR.main(["--dir", str(tmp_path / "port")]) == 0
    got = capsys.readouterr().out
    assert got == _as_port(_jax_main(monkeypatch, capsys, tmp_path / "jax"))
    assert got.startswith("## Dry-run matrix (12 compiled, 2 skipped-by-design, 1 failed, "
                          "15 cells)\n")
    assert "## Roofline (single-pod 32x8, per device)" in got


@pytest.fixture
def fake_group():
    import torch.distributed as dist

    yield DR.fake_group
    TC.set_mesh(None)
    TC.set_tp(True)
    TC.set_fsdp(True)
    if dist.is_initialized():
        dist.destroy_process_group()


def test_main_over_the_ports_own_json(tmp_path, fake_group, monkeypatch, capsys):
    """What the port's dry runs write: ``dryrun_quegel`` on both meshes at
    |V| 2^12, |E| 2^14, and a tinyllama train_4k cell traced by
    ``_lower_one`` on the (2, 4) fake mesh, written as ``lower_cell``
    writes a compiled single-pod cell."""
    out = tmp_path / "port"
    for mp in ([], ["--multi-pod"]):
        assert DQ.main(["--log-v", "12", "--log-e", "14", "--out", str(out), *mp]) == 0
    fake_group(8)
    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    TC.set_mesh(mesh)
    TC.set_tp(True)
    cfg = dc.replace(reduced(get_arch("tinyllama-1.1b")), vocab=512)
    sc = dc.replace(SHAPES["train_4k"], seq_len=64, global_batch=4)
    full = DR._lower_one(cfg, sc, mesh, ("data",), n_micro=2)
    rl = RL.Roofline(arch="tinyllama-1.1b", shape="train_4k", mesh=SP, flops=full["flops"],
                     bytes_accessed=full["bytes"], coll_bytes=full["coll"],
                     coll_detail=full["coll_detail"],
                     model_flops=RL.model_flops_per_device(cfg, sc, mesh.size()),
                     peak_mem_bytes=full["peak_bytes"] - full["arg_bytes"])
    cell = dict(arch="tinyllama-1.1b", shape="train_4k", mesh=SP, status="compiled",
                n_micro=2, batch_axes=["data"],
                memory=dict(temp_bytes=max(full["peak_bytes"] - full["arg_bytes"], 0.0),
                            arg_bytes=full["arg_bytes"]),
                roofline=rl.to_dict())
    (out / "tinyllama-1.1b_train_4k_sp.json").write_text(json.dumps(cell, default=str))
    capsys.readouterr()  # the dry runs' own lines
    assert TR.main(["--dir", str(out)]) == 0
    got = capsys.readouterr().out
    jdir = tmp_path / "jax"
    jdir.mkdir()
    for f in sorted(out.glob("*.json")):
        c = json.loads(f.read_text())
        (jdir / f.name).write_text(json.dumps(_jax_cells([c])[0]))
    assert got == _as_port(_jax_main(monkeypatch, capsys, jdir))
    lines = got.splitlines()
    assert lines[0] == "## Dry-run matrix (3 compiled, 0 skipped-by-design, 0 failed, 3 cells)"
    assert [ln.split(" | ")[:4] for ln in lines if ln.startswith("| tinyllama")] == [
        ["| tinyllama-1.1b", "train_4k", "compiled", "—"],
        ["| tinyllama-1.1b", "train_4k", TR.fmt_s(rl.t_compute), TR.fmt_s(rl.t_memory)]]
