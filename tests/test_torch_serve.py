"""The port's SlotServer: twins of ``tests/test_serve.py`` and parity with
the JAX server on the same requests.

Both servers run the same reduced model (the JAX parameters carried over
with ``carry.params_from_numpy``).  Generated tokens, statuses, retirement
order and the ``ServeStats`` counters must be identical; the slot-table
caches after a drain, whose entries every prefill and decode step wrote,
must agree within rtol = atol = 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch, reduced as j_reduced
from repro.launch.serve import Request as JRequest, SlotServer as JServer
from repro.models import transformer as JT

from repro_torch import carry
from repro_torch.configs import get_arch, reduced
from repro_torch.core.runtime import DONE, REJECTED, TIMEOUT, tree_leaves
from repro_torch.launch import serve
from repro_torch.launch.serve import Request, SlotServer
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny models: the test workers
    share the box, and torch's idle threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_model(arch: str, dtype: str = "float32"):
    cfg = dataclasses.replace(j_reduced(j_arch(arch)), dtype=dtype)
    return cfg, JT.init_params(cfg, jax.random.PRNGKey(0))


def _model(arch: str, dtype: str = "float32", **over):
    """(JAX cfg, JAX params, port cfg, the same params as tensors); ``over``
    replaces config fields the parameters do not depend on."""
    jcfg, jp = _jax_model(arch, dtype)
    jcfg = dataclasses.replace(jcfg, **over)
    cfg = dataclasses.replace(reduced(get_arch(arch)), dtype=dtype, **over)
    return jcfg, jp, cfg, carry.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def setup():
    _, _, cfg, params = _model("tinyllama-1.1b")
    return cfg, params


def _server(cfg, params, **kw):
    return SlotServer(cfg, params, device="cpu", **kw)


def _reqs(cfg, n, seed=0, max_new=8):
    rng = np.random.default_rng(seed)
    return [
        Request(i, rng.integers(0, cfg.vocab, int(rng.integers(3, 9)),
                                dtype=np.int32), max_new_tokens=max_new)
        for i in range(n)
    ]


def _greedy(cfg, params, prompt, n):
    """Hand-rolled greedy decode through the full-context forward."""
    toks, out = list(prompt), []
    with torch.no_grad():
        for _ in range(n):
            logits = T.forward(params, cfg, {"tokens": torch.tensor([toks], dtype=torch.int32)})
            nxt = int(torch.argmax(logits[0, -1]))
            out.append(nxt)
            toks.append(nxt)
    return out


# ------------------------------------------------ twins of test_serve.py
def test_all_requests_served(setup):
    cfg, params = setup
    srv = _server(cfg, params, capacity=3, max_len=48)
    reqs = _reqs(cfg, 7)
    for r in reqs:
        srv.submit(r)
    res = srv.run_until_drained()
    assert sorted(res) == list(range(7))
    for r in reqs:
        assert len(res[r.rid]) == r.max_new_tokens


def test_capacity_invariant_outputs(setup):
    """Slot sharing must not change what each request generates."""
    cfg, params = setup
    outs = {}
    for C in (1, 4):
        srv = _server(cfg, params, capacity=C, max_len=48)
        for r in _reqs(cfg, 5, seed=3):
            srv.submit(r)
        outs[C] = srv.run_until_drained()
    for k in outs[1]:
        np.testing.assert_array_equal(outs[1][k], outs[4][k])


def test_greedy_matches_reference_decode(setup):
    """Server output == hand-rolled greedy decode for a single request."""
    cfg, params = setup
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, 5, dtype=np.int32)
    srv = _server(cfg, params, capacity=2, max_len=48)
    srv.submit(Request(0, prompt, max_new_tokens=6))
    assert srv.run_until_drained()[0].tolist() == _greedy(cfg, params, prompt, 6)


def test_shared_rounds_fewer_than_serial(setup):
    cfg, params = setup
    reqs = _reqs(cfg, 6, seed=5, max_new=6)

    def rounds(C):
        srv = _server(cfg, params, capacity=C, max_len=48)
        for r in reqs:
            srv.submit(Request(r.rid, r.prompt, r.max_new_tokens))
        srv.run_until_drained()
        return srv.stats.rounds

    assert rounds(4) < rounds(1)


def test_prefill_one_call_tokens_unchanged(setup):
    """Masked prefill must not change any request's generated tokens vs the
    full-context reference, including prompts prefilled while other slots
    are mid-decode."""
    cfg, params = setup
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in (5, 3, 8, 4)]
    srv = _server(cfg, params, capacity=2, max_len=48)
    for rid, p in enumerate(prompts):
        srv.submit(Request(rid, p, max_new_tokens=5))
    res = srv.run_until_drained()
    for rid, p in enumerate(prompts):
        assert res[rid].tolist() == _greedy(cfg, params, p, 5), rid


def test_prefill_is_one_call_per_admission(setup, monkeypatch):
    """One prefill call per admission, each one table-wide step per prompt
    token (the JAX server's fori_loop body), plus one step per round."""
    cfg, params = setup
    srv = _server(cfg, params, capacity=2, max_len=48)
    calls, steps = [], []
    orig = srv._prefill_slot
    monkeypatch.setattr(srv, "_prefill_slot", lambda *a: (calls.append(1), orig(*a))[1])
    step = T.serve_step
    monkeypatch.setattr(serve.T, "serve_step", lambda *a: (steps.append(1), step(*a))[1])
    reqs = _reqs(cfg, 3, seed=9, max_new=3)
    for r in reqs:
        srv.submit(r)
    srv.run_until_drained()
    assert len(calls) == 3
    assert len(steps) == sum(len(r.prompt) for r in reqs) + srv.stats.rounds


def test_overlong_request_rejected_with_status(setup):
    """prompt + max_new_tokens > max_len is REJECTED up front."""
    cfg, params = setup
    srv = _server(cfg, params, capacity=2, max_len=16)
    srv.submit(Request(0, np.asarray([1, 2, 3], np.int32), max_new_tokens=4))
    srv.submit(Request(1, np.asarray([1, 2, 3, 4, 5], np.int32), max_new_tokens=40))
    res = srv.run_until_drained()
    assert srv.statuses[0] == DONE and len(res[0]) == 4
    assert srv.statuses[1] == REJECTED and len(res[1]) == 0
    assert srv.stats.rejected == 1
    assert srv.stats.requests_done == 1  # rejected requests don't count


def test_server_budget_timeout(setup):
    """A declared token budget below max_new_tokens evicts the request as
    TIMEOUT with the tokens generated so far."""
    cfg, params = setup
    srv = _server(cfg, params, capacity=1, max_len=48)
    srv.submit(Request(0, np.asarray([1, 2, 3], np.int32), max_new_tokens=10, budget=4))
    res = srv.run_until_drained()
    assert srv.statuses[0] == TIMEOUT
    assert len(res[0]) == 4
    assert srv.stats.timeouts == 1


def _retire_order(srv) -> list:
    order = []
    while srv.runtime.pending() or srv.runtime.live.any():
        before = set(srv.results)
        srv.run_round()
        order += sorted(set(srv.results) - before)
    return order


def test_server_sjf_scheduler_orders_by_budget(setup):
    """Under sjf, the shorter declared job is admitted (and so completes)
    first at capacity 1; generated tokens are unchanged."""
    cfg, params = setup
    rng = np.random.default_rng(13)
    long_p = rng.integers(0, cfg.vocab, 4, dtype=np.int32)
    short_p = rng.integers(0, cfg.vocab, 4, dtype=np.int32)

    def run(scheduler):
        srv = _server(cfg, params, capacity=1, max_len=48, scheduler=scheduler)
        srv.submit(Request(0, long_p, max_new_tokens=9, budget=9))
        srv.submit(Request(1, short_p, max_new_tokens=2, budget=2))
        return _retire_order(srv), srv.run_until_drained()

    fifo_order, fifo_res = run("fifo")
    sjf_order, sjf_res = run("sjf")
    assert fifo_order == [0, 1] and sjf_order == [1, 0]
    for rid in (0, 1):
        np.testing.assert_array_equal(fifo_res[rid], sjf_res[rid])


def _suspending_run(cfg, params, reqs, suspend, C=2, max_len=48):
    srv = _server(cfg, params, capacity=C, max_len=max_len)
    for r in reqs:
        srv.submit(Request(r.rid, r.prompt, r.max_new_tokens))
    rounds = 0
    while srv.runtime.pending() or srv.runtime.live.any():
        srv.run_round()
        if suspend and rounds % 2 == 1:
            live = [s for s in range(C) if srv.runtime.live[s]]
            if live:
                srv.runtime.suspend(live)
        rounds += 1
        assert rounds < 10_000
    return srv, srv.run_until_drained()


def test_mid_decode_suspend_resume_token_identical(setup):
    """Requests suspended mid-generation at every other round boundary
    produce exactly the tokens of an uninterrupted run."""
    cfg, params = setup
    reqs = _reqs(cfg, 5, seed=17, max_new=7)
    ref, want = _suspending_run(cfg, params, reqs, suspend=False)
    srv, got = _suspending_run(cfg, params, reqs, suspend=True)
    assert srv.stats.preemptions > 0 and srv.stats.resumes > 0
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert dict(srv.runtime.steps) == dict(ref.runtime.steps)
    assert dict(srv.statuses) == dict(ref.statuses)


def test_server_preemptive_sjf_short_job_preempts(setup):
    """A short request arriving after a long one has taken the only slot
    suspends it, finishes first, and the long one resumes identically."""
    cfg, params = setup
    rng = np.random.default_rng(19)
    long_p = rng.integers(0, cfg.vocab, 4, dtype=np.int32)
    short_p = rng.integers(0, cfg.vocab, 4, dtype=np.int32)

    def run(preemptive):
        srv = _server(cfg, params, capacity=1, max_len=48, scheduler="sjf",
                      preemptive=preemptive)
        srv.submit(Request(0, long_p, max_new_tokens=12, budget=12))
        srv.run_round()  # the long request holds the only slot
        srv.submit(Request(1, short_p, max_new_tokens=2, budget=2))
        return srv, _retire_order(srv), dict(srv.results)

    ref, ref_order, ref_res = run(preemptive=False)
    srv, order, res = run(preemptive=True)
    assert ref_order == [0, 1] and order == [1, 0]
    assert srv.stats.preemptions >= 1
    assert srv.stats.max_inflight > 1  # oversubscribed the single slot
    for rid in (0, 1):
        np.testing.assert_array_equal(res[rid], ref_res[rid])


def test_eos_frees_slot(setup):
    cfg, params = setup
    prompt = np.asarray([1, 2, 3], np.int32)
    probe = _server(cfg, params, capacity=1, max_len=48)
    probe.submit(Request(0, prompt, max_new_tokens=1))
    first = int(probe.run_until_drained()[0][0])
    srv = _server(cfg, params, capacity=1, max_len=48)
    srv.submit(Request(0, prompt, max_new_tokens=10, eos_id=first))
    assert len(srv.run_until_drained()[0]) == 1  # stopped at EOS immediately


# -------------------------------------------------- parity with JAX's server
COUNTERS = ("rounds", "tokens_generated", "rejected", "timeouts", "preemptions",
            "resumes", "max_inflight", "queries_done", "supersteps_total")


def _mixed(vocab, n, seed, max_len, long_every=0):
    """Requests of every outcome: fresh, overlong (REJECTED), budget below
    max_new_tokens (TIMEOUT), an EOS id, declared budgets for sjf."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        plen = int(rng.integers(3, 12))
        new = int(rng.integers(3, 10))
        if long_every and rid % long_every == 0:
            plen, new = 20, 14  # past a 32-position local ring
        kw = dict(max_new_tokens=new, budget=new)
        if rid == 3:
            kw.update(max_new_tokens=max_len)  # REJECTED
        if rid == 4:
            kw.update(budget=2)  # TIMEOUT after 2 tokens
        if rid == 5:
            kw.update(eos_id=int(rng.integers(0, vocab)))
        out.append((rid, rng.integers(0, vocab, plen, dtype=np.int32), kw))
    return out


SHORT = {"tinyllama": "tinyllama-1.1b", "gemma2": "gemma2-9b", "mamba2": "mamba2-780m",
         "recurrentgemma": "recurrentgemma-2b", "deepseek": "deepseek-v2-236b",
         "arctic": "arctic-480b", "whisper": "whisper-base"}


# name -> (arch, server options, requests, {round: requests submitted after it},
#          suspend every other round)
def _scenario(name):
    arch = SHORT[name.split("-")[0]]
    vocab = 256
    every = 2 if arch == "gemma2-9b" else 0
    reqs = _mixed(vocab, 8, seed=len(name), max_len=48, long_every=every)
    late = {}
    kw = dict(capacity=3, max_len=48)
    suspend = name.endswith("suspend")
    if "preemptive" in name:
        kw.update(capacity=2, scheduler="sjf", preemptive=True)
        reqs, late = reqs[:3], {2: reqs[3:]}
    elif name.endswith("-sjf"):
        kw.update(capacity=2, scheduler="sjf")
    return arch, kw, reqs, late, suspend


SCENARIOS = [f"{a}-{m}" for a in ("tinyllama", "gemma2")
             for m in ("fifo", "sjf", "preemptive-sjf", "suspend")] + [
    f"{a}-fifo" for a in ("mamba2", "recurrentgemma", "deepseek", "arctic", "whisper")] + [
    "mamba2-suspend", "deepseek-suspend"]


def _drive(server, request, reqs, late, suspend):
    for rid, prompt, kw in reqs:
        server.submit(request(rid, prompt, **kw))
    order, rounds = [], 0
    while server.runtime.pending() or server.runtime.live.any() or rounds in late:
        before = set(server.results)
        server.run_round()
        rounds += 1
        order += sorted(set(server.results) - before)
        for rid, prompt, kw in late.get(rounds, ()):
            server.submit(request(rid, prompt, **kw))
        if suspend and rounds % 2 == 0:
            live = [s for s in range(server.C) if server.runtime.live[s]]
            if live:
                server.runtime.suspend(live)
        assert rounds < 10_000
    return order


@pytest.mark.parametrize("name", SCENARIOS)
def test_server_matches_jax(name):
    """fifo, sjf, preemptive sjf and every-other-round suspension, on reduced
    tinyllama (stacked layers) and reduced gemma2 (local/global, unrolled)
    with max_len 48, so that gemma2's 32-position local ring wraps; fifo on
    the other five families (SSD and MoE + MLA stacked, RG-LRU and whisper
    unrolled), and suspension on mamba2 and deepseek, whose payloads carry
    the ``state``/``conv`` and ``ckv``/``krope`` rows."""
    arch, kw, reqs, late, suspend = _scenario(name)
    jcfg, jp, cfg, tp = _model(arch)
    jsrv = JServer(jcfg, jp, **kw)
    tsrv = SlotServer(cfg, tp, device="cpu", **kw)
    j_order = _drive(jsrv, JRequest, reqs, late, suspend)
    t_order = _drive(tsrv, Request, reqs, late, suspend)
    assert t_order == j_order
    assert sorted(tsrv.results) == sorted(jsrv.results)
    for rid in jsrv.results:
        assert tsrv.results[rid].tolist() == np.asarray(jsrv.results[rid]).tolist(), rid
        assert tsrv.results[rid].dtype == np.int32
    assert dict(tsrv.statuses) == dict(jsrv.statuses)
    assert dict(tsrv.runtime.steps) == dict(jsrv.runtime.steps)
    for c in COUNTERS:
        assert getattr(tsrv.stats, c) == getattr(jsrv.stats, c), c
    assert {TIMEOUT, REJECTED} <= set(jsrv.statuses.values())
    if "preemptive" in name or suspend:
        assert jsrv.stats.preemptions > 0
    want = jax.tree.leaves(jsrv.cache)
    got = tree_leaves(tsrv.cache)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _jax_greedy_agrees(jcfg, jp, prompt, tokens) -> int:
    """Where ``tokens`` first leave JAX's no-cache greedy decode of
    ``prompt`` (len(tokens) when they never do), from one causal forward
    over prompt + tokens: position L-1+i holds the logits of step i."""
    seq = jnp.asarray([list(prompt) + list(tokens)], jnp.int32)
    logits = jax.jit(lambda p, b: JT.forward(p, jcfg, b))(jp, {"tokens": seq})
    ref = np.asarray(jnp.argmax(logits[0, len(prompt) - 1 : -1], axis=-1))
    bad = np.flatnonzero(ref != np.asarray(tokens))
    return int(bad[0]) if len(bad) else len(tokens)


def test_ring_rewrite_at_admission_matches_jax():
    """A latent JAX fault, kept because JAX is the reference: when a slot's
    local ring is full, another slot's prefill rewrites token 0 at this
    slot's ``base_pos % length``, the oldest entry still inside its window,
    and the same round's decode attends to it.  Reduced gemma2 (window
    32), C=2, max_len 48: a 30-token request with 16 new tokens and a
    6-token request submitted after 6 rounds.  The long request's tokens
    equal the JAX server's and leave JAX's greedy forward; alone, they
    equal it."""
    jcfg, jp, cfg, tp = _model("gemma2-9b")
    rng = np.random.default_rng(0)
    long_p = rng.integers(0, cfg.vocab, 30, dtype=np.int32)
    short_p = rng.integers(0, cfg.vocab, 6, dtype=np.int32)
    reqs = [(0, long_p, dict(max_new_tokens=16))]
    late = {6: [(1, short_p, dict(max_new_tokens=4))]}
    out = {}
    for key, srv, req, lt in (
            ("jax", JServer(jcfg, jp, capacity=2, max_len=48), JRequest, late),
            ("port", SlotServer(cfg, tp, capacity=2, max_len=48, device="cpu"), Request, late),
            ("alone", SlotServer(cfg, tp, capacity=2, max_len=48, device="cpu"), Request, {})):
        _drive(srv, req, reqs, lt, suspend=False)
        out[key] = [np.asarray(v).tolist() for _, v in sorted(srv.results.items())]
    assert out["port"] == out["jax"]
    first_off = _jax_greedy_agrees(jcfg, jp, long_p, out["port"][0])
    assert 0 < first_off < 16
    assert _jax_greedy_agrees(jcfg, jp, long_p, out["alone"][0]) == 16


def _both_servers(arch, reqs, C, **over):
    """The JAX server's and the port's tokens for ``reqs`` at capacity C
    (max_len 48, fifo), each as {rid: list}."""
    jcfg, jp, cfg, tp = _model(arch, **over)
    out = []
    for srv, req in ((JServer(jcfg, jp, capacity=C, max_len=48), JRequest),
                     (SlotServer(cfg, tp, capacity=C, max_len=48, device="cpu"), Request)):
        _drive(srv, req, reqs, {}, suspend=False)
        out.append({r: np.asarray(v).tolist() for r, v in srv.results.items()})
    return out


def _five(seed=0):
    rng = np.random.default_rng(seed)
    return [(rid, rng.integers(0, 256, int(rng.integers(3, 9)), dtype=np.int32),
             dict(max_new_tokens=6)) for rid in range(5)]


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
def test_recurrent_state_absorbs_other_slots_matches_jax(arch):
    """A latent JAX fault, kept because JAX is the reference: prefill runs
    one table-wide step per prompt token, and every other slot's SSD or
    RG-LRU state takes in its token-0 step; the first decode step feeds
    the last prompt token again.  So a request's tokens depend on the
    capacity, and even at C=1 they leave JAX's greedy forward.  The
    port's tokens equal the JAX server's at C=1 and C=4."""
    reqs = _five()
    jax1, port1 = _both_servers(arch, reqs, 1)
    jax4, port4 = _both_servers(arch, reqs, 4)
    assert port1 == jax1 and port4 == jax4
    assert any(jax1[r] != jax4[r] for r in jax1)
    jcfg, jp = _jax_model(arch)
    assert any(_jax_greedy_agrees(jcfg, jp, prompt, jax1[rid]) < len(jax1[rid])
               for rid, prompt, _ in reqs)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "arctic-480b"])
def test_moe_capacity_shared_across_slots_matches_jax(arch):
    """A latent JAX fault, kept because JAX is the reference: a decode step
    routes its C slots as one batch of C tokens with capacity
    ceil(C*K/E * 1.25), so what shares a request's table can drop its
    assignments, and its tokens depend on the capacity.  The port's
    tokens equal the JAX server's at C=1 and C=4; under
    ``capacity_factor = n_experts`` nothing drops and the two agree."""
    reqs = _five()
    jax1, port1 = _both_servers(arch, reqs, 1)
    jax4, port4 = _both_servers(arch, reqs, 4)
    assert port1 == jax1 and port4 == jax4
    assert any(jax1[r] != jax4[r] for r in jax1)
    every = float(reduced(get_arch(arch)).n_experts)
    jax1, port1 = _both_servers(arch, reqs, 1, capacity_factor=every)
    jax4, port4 = _both_servers(arch, reqs, 4, capacity_factor=every)
    assert port1 == jax1 == port4 == jax4


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b", "deepseek-v2-236b",
                                  "arctic-480b", "whisper-base"])
def test_jax_payload_resumes_in_the_port(arch):
    """A JAX slot suspended after 3 rounds: its payload's cache rows (SSD
    or RG-LRU states and conv inputs, MLA latents, whisper's ``enc_out``)
    equal the port's on the same axes, and, carried over with
    ``carry.cache_from_numpy``, resume in the port to the JAX server's
    tokens."""
    jcfg, jp, cfg, tp = _model(arch)
    prompt = np.random.default_rng(29).integers(0, cfg.vocab, 6, dtype=np.int32)
    jsrv = JServer(jcfg, jp, capacity=2, max_len=32)
    tsrv = SlotServer(cfg, tp, capacity=2, max_len=32, device="cpu")
    for srv, req in ((jsrv, JRequest), (tsrv, Request)):
        srv.submit(req(0, prompt, max_new_tokens=10))
        for _ in range(3):
            srv.run_round()
    slot = [int(np.flatnonzero(jsrv.runtime.live)[0])]
    jpay, tpay = jsrv.slot_suspend(slot)[0], tsrv.slot_suspend(slot)[0]
    want, got = jax.tree.leaves(jpay["cache"]), tree_leaves(tpay["cache"])
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    ref = JServer(jcfg, jp, capacity=2, max_len=32)
    ref.submit(JRequest(0, prompt, max_new_tokens=10))
    fresh = SlotServer(cfg, tp, capacity=2, max_len=32, device="cpu")
    carried = dict(jpay, cache=carry.cache_from_numpy(
        jax.tree.map(np.asarray, jpay["cache"]), device="cpu"))
    fresh.runtime.restore_pending(0, Request(0, prompt, max_new_tokens=10),
                                  payload=carried, steps_done=3)
    assert fresh.run_until_drained()[0].tolist() == \
        np.asarray(ref.run_until_drained()[0]).tolist()


def test_bf16_served_only_where_jax_serves():
    """bf16 parameters against the float32 slot cache: with stacked layers
    (tinyllama) JAX's scan raises and the port refuses up front; unrolled
    (gemma2) both serve, with identical tokens."""
    jcfg, jp, cfg, tp = _model("tinyllama-1.1b", "bfloat16")
    with pytest.raises(TypeError, match="carry"):
        jsrv = JServer(jcfg, jp, capacity=2, max_len=32)
        jsrv.submit(JRequest(0, np.asarray([1, 2, 3], np.int32), 4))
        jsrv.run_until_drained()
    with pytest.raises(ValueError, match="stacked layers"):
        SlotServer(cfg, tp, capacity=2, max_len=32, device="cpu")
    jcfg, jp, cfg, tp = _model("gemma2-9b", "bfloat16")
    reqs = [(rid, prompt, kw) for rid, prompt, kw in _mixed(256, 5, seed=1, max_len=48)]
    jsrv = JServer(jcfg, jp, capacity=2, max_len=48)
    tsrv = SlotServer(cfg, tp, capacity=2, max_len=48, device="cpu")
    _drive(jsrv, JRequest, reqs, {}, False)
    _drive(tsrv, Request, reqs, {}, False)
    assert {r: v.tolist() for r, v in tsrv.results.items()} == \
        {r: np.asarray(v).tolist() for r, v in jsrv.results.items()}


def test_suspend_payload_matches_jax_and_resumes_across():
    """A slot's suspend payload holds the JAX rows on the JAX axes (1 for
    stacked ``blocks``, 0 elsewhere), and a JAX payload, its cache carried
    over with ``carry.cache_from_numpy``, resumes in the port to the JAX
    server's tokens."""
    jcfg, jp, cfg, tp = _model("tinyllama-1.1b")
    prompt = np.random.default_rng(23).integers(0, cfg.vocab, 6, dtype=np.int32)
    jsrv = JServer(jcfg, jp, capacity=2, max_len=32)
    tsrv = SlotServer(cfg, tp, capacity=2, max_len=32, device="cpu")
    for srv, req in ((jsrv, JRequest), (tsrv, Request)):
        srv.submit(req(0, prompt, max_new_tokens=10))
        for _ in range(3):
            srv.run_round()
    live = [list(np.flatnonzero(srv.runtime.live)) for srv in (jsrv, tsrv)]
    assert live[0] == live[1] and len(live[0]) == 1
    jpay = jsrv.slot_suspend(live[0])[0]
    tpay = tsrv.slot_suspend(live[0])[0]
    assert len(tpay["generated"]) == 3
    assert {k: v for k, v in tpay.items() if k != "cache"} == \
        {k: v for k, v in jpay.items() if k != "cache"}
    want = jax.tree.leaves(jpay["cache"])
    got = tree_leaves(tpay["cache"])
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    ref = JServer(jcfg, jp, capacity=2, max_len=32)
    ref.submit(JRequest(0, prompt, max_new_tokens=10))
    fresh = SlotServer(cfg, tp, capacity=2, max_len=32, device="cpu")
    carried = dict(jpay, cache=carry.cache_from_numpy(
        jax.tree.map(np.asarray, jpay["cache"]), device="cpu"))
    assert [c.dtype for c in tree_leaves(carried["cache"])] == [torch.float32] * len(want)
    fresh.runtime.restore_pending(0, Request(0, prompt, max_new_tokens=10),
                                  payload=carried, steps_done=3)
    got = fresh.run_until_drained()[0]
    assert got.tolist() == np.asarray(ref.run_until_drained()[0]).tolist()
    assert fresh.stats.resumes == 1 and fresh.runtime.steps[0] == 10


def test_cache_key_matches_jax():
    jcfg, jp, cfg, tp = _model("tinyllama-1.1b")
    jsrv = JServer(jcfg, jp, capacity=1, max_len=16)
    tsrv = SlotServer(cfg, tp, capacity=1, max_len=16, device="cpu")
    for prompt, new, eos in (([1, 2, 3], 4, -1), ([7], 9, 5)):
        p = np.asarray(prompt, np.int32)
        assert tsrv.cache_key(Request(0, p, new, eos)) == jsrv.cache_key(JRequest(0, p, new, eos))


def test_cli_serves_on_the_cpu(capsys):
    assert serve.main(["--device", "cpu", "--requests", "3", "--max-new", "4"]) == 0
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
